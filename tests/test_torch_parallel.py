"""The port's sharded Monte-Carlo sweeps (``parallel/``) on the CPU: a
process group of one rank in this process, of two ranks in two worker
processes joined by gloo, and the JAX package's sweeps on the 8-device CPU
mesh that tests/conftest.py sets up.

The two workers are this file run as a program (its ``__main__`` block),
each on one thread; they write what their rank computed to an ``.npz``
that the tests read. Inputs are made with numpy and handed to both
packages. Tolerances: the 2D particle's rollouts and statistics, float64,
1e-12 between 2 ranks and 1, 1e-10 against JAX (its float32 counts and
iteration means 1e-6); the MPC sweep's lanes 1e-12 between 2 ranks and 1,
its statistics (float32 sums, as the JAX package's) equal in the counts and
within an ulp of float32 a lane in the means, where the two ranks' partial
sums add in another order, and 1e-6 against JAX.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.control import from_gait as jfrom_gait
from contactimplicitmpc_tpu.control.rollout import MPCRollout as JMPCRollout
from contactimplicitmpc_tpu.models import hopper_2d as jhopper
from contactimplicitmpc_tpu.models import particle_2d as jparticle
from contactimplicitmpc_tpu.parallel import make_mesh as jmake_mesh
from contactimplicitmpc_tpu.parallel import \
    make_sharded_mpc_rollouts as jmake_sharded_mpc
from contactimplicitmpc_tpu.parallel import \
    monte_carlo_rollouts as jmonte_carlo
from contactimplicitmpc_tpu.parallel import \
    sharded_rollout_stats as jsharded_stats
from contactimplicitmpc_tpu.utils.gaits import load_gait as jload_gait

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch import interop
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import (
    CONFIGURATION, default_mpc_ip_options)
from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
from contactimplicitmpc_tpu_torch.control.objective import \
    tracking_velocity_objective
from contactimplicitmpc_tpu_torch.control.rollout import (
    MPCRollout, mpc_rollout)
from contactimplicitmpc_tpu_torch.control.trajectory import (
    from_gait, initial_conditions)
from contactimplicitmpc_tpu_torch.models.hopper_2d import hopper_2d
from contactimplicitmpc_tpu_torch.models.particle_2d import \
    particle_2d
from contactimplicitmpc_tpu_torch.parallel import (
    distributed, make_mesh, make_sharded_mpc_rollouts, monte_carlo_rollouts,
    sharded_mpc_rollouts, sharded_rollout_stats, sharded_rollouts)
from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
STEPS, H = 30, 0.01                 # tests/test_parallel.py's rollouts
MPC_LANES, MPC_STEPS = 4, 10        # the 2D hopper's sweep
F32_ULPS = MPC_LANES * 2.0 ** -23   # an ulp of float32 a lane summed
CIMPC_VARS = ("CIMPC_COORDINATOR", "CIMPC_NUM_PROCESSES", "CIMPC_PROCESS_ID",
              "MASTER_ADDR", "WORLD_SIZE", "RANK")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test here, and the module's fixtures, run PyTorch on one
    thread: a batched LAPACK factorization (the pivoted-LU KKT backend) does
    not return on some CPU builds under a thread count between 2 and the
    core count, and one thread a test process keeps the processes from
    competing for the cores. Set here, not at import: a test process
    imports every test file, and the last import would win."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def particle_batch(n=16):
    """tests/test_parallel.py's lanes: x spread over [−1, 1] at height 1,
    at rest."""
    xs = np.linspace(-1.0, 1.0, n)
    return np.stack([xs, np.ones(n)], axis=1), np.zeros((n, 2))


def hopper_sweep():
    """The 2D hopper's ``mpc_rollout`` (examples/hopper_monte_carlo.py's
    objective, direct mode, fixed 8-iteration knot solves, float64 sim
    solves) as a batched ``rollout_fn``, its reference, and 4 lanes offset
    by 0.05 · uniform(−1, 1) from numpy.random.default_rng(3)."""
    model, env = hopper_2d, pt.flat_2d_lc
    dims = pt.dims_of(model, env)
    n_sample, h_mpc, kappa = 5, 10, 1.0e-4
    ref = from_gait(model, env, load_gait("hopper_2D", "gait_in_place"),
                    kappa=kappa, dtype=F64, device="cpu")
    qw = np.tile(1e-2 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    qw[-2:] = 1e-1 * np.array([0.1, 3, 1, 3])
    vw = np.tile(1e-3 * np.array([0.1, 3, 1, 3]), (h_mpc, 1))
    vw[:2] = 1e1 * np.array([0.1, 3, 1, 3])
    obj = tracking_velocity_objective(
        dims, h_mpc, q=qw, v=vw, u=np.tile([3e-3, 1e0], (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, 1)), b=1e-100 * np.ones((h_mpc, 2)),
        dtype=F64, device="cpu")
    sim_opts = IPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                         undercut=float("inf"), max_ls=6)

    def rollout(q1s, v1s):
        return mpc_rollout(
            model, env, ref, obj, MPC_STEPS, h_mpc, n_sample, kappa,
            CONFIGURATION, q1s, v1s,
            n_opts=NewtonOptions(r_tol=3e-4, max_iter=5, fixed_ip_iters=8),
            ip_opts=default_mpc_ip_options(kappa), sim_opts=sim_opts)

    q1, v1 = initial_conditions(ref)
    off = 0.05 * np.random.default_rng(3).uniform(-1, 1, (MPC_LANES, 4))
    off[0] = 0.0
    q1s = q1[None] + torch.as_tensor(off)
    return rollout, ref, n_sample, q1s, v1.expand_as(q1s).contiguous()


def sweep(mesh):
    """What a rank computes on ``mesh``: its lanes of the particle's
    rollouts, the particle's and the hopper's sweep statistics."""
    q1, v1 = (torch.as_tensor(x) for x in particle_batch())
    traj = sharded_rollouts(mesh, particle_2d, pt.flat_2d_lc, STEPS, H, q1,
                            v1)
    stats = sharded_rollout_stats(mesh, particle_2d, pt.flat_2d_lc, STEPS,
                                  H, q1, v1)
    rollout, ref, n_sample, hq1, hv1 = hopper_sweep()
    mpc, mpc_stats = make_sharded_mpc_rollouts(mesh, rollout, ref,
                                               n_sample)(hq1, hv1)
    out = {"q": traj.q.numpy(), "converged": traj.converged.numpy(),
           "mpc_q": mpc.q.numpy()}
    out.update({f"stats_{k}": v.numpy() for k, v in stats._asdict().items()})
    out.update({f"mpc_{k}": v.numpy() for k, v in mpc_stats._asdict().items()})
    return out


def worker(out_dir):
    """One rank of the two-process runs (this file's ``__main__``)."""
    torch.set_num_threads(1)
    assert distributed.initialize(device="cpu")
    rank = dist.get_rank()
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    mesh = make_mesh(device="cpu")
    glob = distributed.make_global_mesh()
    out = sweep(mesh)
    local = 0.1 * (rank * 8 + np.arange(8.0))
    back = distributed.process_local_slice(
        distributed.global_batch(mesh, local, device="cpu"))
    out.update(rank=rank, mesh_shape=tuple(mesh.shape),
               mesh_names=list(mesh.mesh_dim_names),
               global_shape=tuple(glob.shape), round_trip=back)
    out["ragged_raises"] = False
    try:
        sharded_rollouts(mesh, particle_2d, pt.flat_2d_lc, 2, H,
                         *(torch.zeros((3, 2), dtype=F64) for _ in range(2)))
    except ValueError:
        out["ragged_raises"] = True
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp, n=2):
    """Run this file as ``n`` ranks joined through ``CIMPC_*``; the
    workers' outputs by rank."""
    port = _free_port()
    procs = []
    for pid in range(n):
        env = {k: v for k, v in os.environ.items() if k not in CIMPC_VARS}
        env.update(CIMPC_COORDINATOR=f"127.0.0.1:{port}",
                   CIMPC_NUM_PROCESSES=str(n), CIMPC_PROCESS_ID=str(pid),
                   JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{text}"
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in
            range(n)]


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo process group of one rank in this process, its mesh, and
    what it computes; the group ends with the module."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh, sweep(mesh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("ranks"))


# ---- meshes and the process group -------------------------------------------

def test_initialize_single_process(monkeypatch):
    """A plain single process (no variables) is left alone."""
    for k in CIMPC_VARS:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False


def test_mesh_world_of_one(world_of_one):
    mesh, _ = world_of_one
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("dp", "kn")
    assert dist.get_backend() == "gloo"
    assert tuple(distributed.make_global_mesh().shape) == (1, 1)
    with pytest.raises(ValueError):
        make_mesh(2)


def test_mesh_world_of_two(two_ranks):
    """Two ranks joined by ``initialize`` through the CIMPC_* variables:
    a (2, 1) mesh with the JAX package's axis names on each."""
    for rank, out in enumerate(two_ranks):
        assert int(out["rank"]) == rank
        assert tuple(out["mesh_shape"]) == (2, 1)
        assert list(out["mesh_names"]) == ["dp", "kn"]
        assert tuple(out["global_shape"]) == (2, 1)


def test_global_batch_round_trip(two_ranks):
    """``global_batch`` puts a rank's own lanes on its device and
    ``process_local_slice`` brings them back."""
    for rank, out in enumerate(two_ranks):
        np.testing.assert_array_equal(out["round_trip"],
                                      0.1 * (rank * 8 + np.arange(8.0)))


def test_ragged_lanes_raise(two_ranks):
    """3 lanes over 2 ranks raise, as the JAX shardings do."""
    assert all(bool(out["ragged_raises"]) for out in two_ranks)


# ---- two ranks against one --------------------------------------------------

def test_sharded_rollouts_two_ranks_match_one(world_of_one, two_ranks):
    _, one = world_of_one
    q = np.concatenate([out["q"] for out in two_ranks])
    np.testing.assert_allclose(q, one["q"], rtol=0, atol=1e-12)
    assert all(out["converged"].all() for out in two_ranks)


def test_sharded_stats_two_ranks_match_one(world_of_one, two_ranks):
    _, one = world_of_one
    assert float(one["stats_n_rollouts"]) == 16.0
    assert float(one["stats_success_rate"]) == 1.0
    for out in two_ranks:
        for k in ("n_rollouts", "success_rate", "mean_iterations",
                  "mean_final_q"):
            np.testing.assert_allclose(out[f"stats_{k}"], one[f"stats_{k}"],
                                       rtol=0, atol=1e-12, err_msg=k)


def test_mpc_sweep_two_ranks_match_one(world_of_one, two_ranks):
    """``make_sharded_mpc_rollouts`` on the 2D hopper's ``mpc_rollout``:
    the lanes and every statistic, 2 ranks against 1."""
    _, one = world_of_one
    assert float(one["mpc_n_rollouts"]) == MPC_LANES
    assert float(one["mpc_success_rate"]) == 1.0
    np.testing.assert_allclose(
        np.concatenate([out["mpc_q"] for out in two_ranks]), one["mpc_q"],
        rtol=0, atol=1e-12)
    names = [k for k in one if k.startswith("mpc_") and k != "mpc_q"]
    assert len(names) == 9
    for out in two_ranks:
        for k in names:
            # float32 sums: a rank's partial sums added across ranks round
            # apart from one rank's sum by up to an ulp a lane
            exact = k in ("mpc_n_rollouts", "mpc_success_rate")
            np.testing.assert_allclose(out[k], one[k], rtol=0 if exact else
                                       F32_ULPS, atol=0, err_msg=k)


# ---- against the JAX package ------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "tests/conftest.py sets 8 CPU devices"
    return jmake_mesh(8)


def test_monte_carlo_rollouts_match_jax():
    q1, v1 = particle_batch()
    want = jmonte_carlo(jparticle, ci.flat_2d_lc, STEPS, H, jnp.asarray(q1),
                        jnp.asarray(v1))
    got = monte_carlo_rollouts(particle_2d, pt.flat_2d_lc, STEPS, H,
                               torch.as_tensor(q1), torch.as_tensor(v1))
    np.testing.assert_allclose(got.q.numpy(), want.q, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)


def test_sharded_stats_match_jax(world_of_one, jax_mesh):
    """The port's statistics against JAX's ``psum`` over 8 devices."""
    _, one = world_of_one
    q1, v1 = particle_batch()
    want = jsharded_stats(jax_mesh, jparticle, ci.flat_2d_lc, STEPS, H,
                          jnp.asarray(q1), jnp.asarray(v1))
    np.testing.assert_allclose(one["stats_mean_final_q"], want.mean_final_q,
                               rtol=0, atol=1e-10)
    for k in ("n_rollouts", "success_rate", "mean_iterations"):
        assert one[f"stats_{k}"].dtype == np.float32, k
        np.testing.assert_allclose(one[f"stats_{k}"], getattr(want, k),
                                   rtol=0, atol=1e-6, err_msg=k)


def fake_rollouts(n=8, steps=10, n_sample=5, seed=5, fail=(1, 4, 6)):
    """A seeded, numpy-made MPCRollout of ``n`` lanes; the lanes ``fail``
    have one failed sim step."""
    rng = np.random.default_rng(seed)
    nq, nu, nc, nb = 4, 2, 1, 2
    conv = np.ones((n, steps), bool)
    for lane in fail:
        conv[lane, rng.integers(steps)] = False
    periods = steps // n_sample
    return dict(
        q=rng.normal(0.5, 0.1, (n, steps + 2, nq)),
        u=rng.normal(0.0, 1.0, (n, steps, nu)),
        gamma=rng.uniform(0.0, 1.0, (n, steps, nc)),
        b=rng.uniform(0.0, 1.0, (n, steps, nb)), sim_converged=conv,
        mpc_r_norm=rng.uniform(0.0, 1e-3, (n, periods)),
        newton_iterations=rng.integers(1, 6, (n, periods)).astype(np.int32),
        sim_iterations=rng.integers(3, 20, (n, steps)).astype(np.int32),
        sim_rvio=rng.uniform(0.0, 1e-6, (n, steps)))


def sweep_stats_both(lanes, jax_mesh):
    """JAX's and the port's sweep statistics of one MPCRollout handed to
    both through a ``rollout_fn`` that looks each lane up by its q1[0]
    (no MPC is compiled): (JAX stats, port stats)."""
    n_sample = 5
    jref = jfrom_gait(jhopper, ci.flat_2d_lc,
                      jload_gait("hopper_2D", "gait_in_place"), kappa=1e-4)
    n = lanes["q"].shape[0]
    q1 = np.zeros((n, 4))
    q1[:, 0] = np.arange(n)

    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    want = jmake_sharded_mpc(
        jax_mesh, lambda q, v: JMPCRollout(**{
            k: x[q[0].astype(jnp.int32)] for k, x in jl.items()}),
        jref, n_sample)(jnp.asarray(q1), jnp.asarray(q1))[1]
    tl = {k: torch.as_tensor(v) for k, v in lanes.items()}
    got = sharded_mpc_rollouts(
        make_mesh(device="cpu"), lambda q, v: MPCRollout(**{
            k: x[q[:, 0].long()] for k, x in tl.items()}),
        interop.contact_traj(jref, device="cpu"), n_sample,
        torch.as_tensor(q1), torch.as_tensor(q1))[1]
    return want, got


def test_mpc_sweep_stats_match_jax(world_of_one, jax_mesh):
    """``MPCSweepStats`` of the same 8 lanes, 3 of them with a failed
    step: success 5/8, the tracking errors and the residual averaged over
    the 5."""
    want, got = sweep_stats_both(fake_rollouts(), jax_mesh)
    assert float(got.success_rate) == 5.0 / 8.0
    for k in got._fields:
        assert getattr(got, k).dtype == torch.float32, k
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_mpc_sweep_stats_all_failed(world_of_one, jax_mesh):
    """Every lane failed: the means over successful lanes are 0 (the sums
    over max(n_ok, 1)), not NaN, in both packages."""
    want, got = sweep_stats_both(fake_rollouts(fail=range(8)), jax_mesh)
    assert float(got.success_rate) == 0.0
    for k in ("q_err", "u_err", "gamma_err", "b_err", "mean_r_norm"):
        assert float(getattr(got, k)) == 0.0 == float(getattr(want, k)), k
    for k in got._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


if __name__ == "__main__":
    worker(sys.argv[1])
