"""Every ported example (``examples/torch_*.py``) on the card at a tiny
size, and the point-foot trot closed loop at full length
(tests/test_mpc_point_foot.py::test_point_foot_trot_mpc's configuration).

The tests are marked ``cuda`` and skip where CUDA is absent. This file
imports neither JAX nor the JAX package; on a machine that has only
PyTorch, leave out tests/conftest.py (it configures JAX) and show what the
examples print with ``-s``:

    python -m pytest --noconftest -m cuda -s tests/test_torch_examples_cuda.py

Each example runs its ``main`` without ``--cpu`` on the cases of the CPU
tests (``tests/test_torch_examples_*.py``), without the figure flags, and
prints the knot kernel's launches beside what the example printed: every
MPC example launches it, the others (``NO_KNOTS``) do not. Where
matplotlib is not installed, an example asked for a figure raises.
"""

import importlib.util

import numpy as np
import pytest
import torch

import test_torch_examples_bipeds as bipeds
import test_torch_examples_centroidal as centroidal
import test_torch_examples_hoppers as hoppers
import test_torch_examples_quadruped as quadruped
import test_torch_examples_walls as walls
from contactimplicitmpc_tpu_torch.ops.knot_ip import knot_ip
from test_torch_examples import example, run_case

# the Monte-Carlo and point-foot examples at tests/test_torch_examples.py's
# sizes, and the MIQP wall pendulum at tests/test_torch_miqp.py's
OTHERS = [
    pytest.param("torch_quadruped_monte_carlo", ["--n", "2", "--steps", "5"],
                 ["runs: 2  success rate: 1.000", "MPC solves/s"], (),
                 id="quadruped_monte_carlo"),
    pytest.param("torch_hopper_monte_carlo", ["--runs", "2", "--steps", "5"],
                 ["2 runs x 5 steps in", "solver success rate: 1.00"], (),
                 id="hopper_monte_carlo"),
    pytest.param("torch_point_foot_trot", ["--gait", "stand_v0", "--steps",
                                           "10", "--push"],
                 ["sim converged: 1.000", "tracking: q="], (),
                 id="point_foot_push"),
    pytest.param("torch_miqp_wallpendulum", ["--steps", "30"],
                 ["wall pendulum MIQP: horizon 20, 729 mode sequences",
                  "solve time: mean", "recovered upright through 5 pushes:"],
                 (), id="miqp_wallpendulum"),
]
CASES = (centroidal.CASES + quadruped.CASES + bipeds.CASES + hoppers.CASES
         + walls.CASES + OTHERS)
# the examples with no knot solve (simulation only, the Raibert policies, the
# MIQP); every other one solves its knots on the card's kernel
NO_KNOTS = {"torch_centroidal_wall_sim", "torch_hopper_raibert",
            "torch_raibert_variants", "torch_miqp_wallpendulum"}


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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the examples run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,argv,lines,figures", CASES)
def test_example_on_the_card(card, name, argv, lines, figures, capsys):
    knot_ip.launches = 0
    # the examples JAX runs in float64 only run float32 on the card, the
    # knot kernel's type, and print which
    lines = [line.replace("float64", "float32") for line in lines]
    out = run_case(capsys, name, argv, lines, cpu=False)
    with capsys.disabled():
        print(f"\n---- {name} {' '.join(argv)}: knot_ip launches "
              f"{knot_ip.launches}\n{out}", flush=True)
    assert (knot_ip.launches > 0) == (name not in NO_KNOTS), knot_ip.launches


@pytest.mark.cuda
def test_figure_without_matplotlib_raises(card, tmp_path):
    """The card's machine has no matplotlib: an example asked for a figure
    raises there, after its run, and does not skip the figure silently."""
    if importlib.util.find_spec("matplotlib") is not None:
        pytest.skip("matplotlib is installed here")
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        example("torch_centroidal_wall_sim").main(
            ["--steps", "2", "--gif", str(tmp_path / "wall.gif")])


@pytest.mark.cuda
def test_point_foot_trot_mpc(card, capsys):
    """tests/test_mpc_point_foot.py::test_point_foot_trot_mpc's closed loop
    on the card, float32 with fixed 8-iteration knot solves (the kernel's
    form) and the float32 sim options of chip_smoke.py's path D: the
    in-place trot, 100 sim steps, the nominal lane converges every step,
    tracks q within 0.05, and its lowest body height stays above half the
    reference's initial height ``q[1]``."""
    import contactimplicitmpc_tpu_torch as pt
    from contactimplicitmpc_tpu_torch.control.implicit_dynamics import \
        CONFIGURATION
    from contactimplicitmpc_tpu_torch.control.newton import NewtonOptions
    from contactimplicitmpc_tpu_torch.control.objective import \
        tracking_velocity_objective
    from contactimplicitmpc_tpu_torch.control.rollout import mpc_rollout
    from contactimplicitmpc_tpu_torch.control.trajectory import (
        from_gait, initial_conditions, tracking_errors)
    from contactimplicitmpc_tpu_torch.device import describe, timed
    from contactimplicitmpc_tpu_torch.models import point_foot_quadruped
    from contactimplicitmpc_tpu_torch.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu_torch.utils.gaits import load_gait

    model, env, dtype = point_foot_quadruped, pt.flat_3d_lc, torch.float32
    dims = pt.dims_of(model, env)
    ref = from_gait(model, env, load_gait("point_foot_quadruped",
                                          "inplace_trot_v1"),
                    update_friction=True, dtype=dtype, device=card)
    n_sample, h_mpc, kappa, steps = 5, 10, 2.0e-4, 100
    v_w = 1e-3 * np.concatenate([np.ones(3), 1e3 * np.ones(3), np.ones(12)])
    q_body = np.array([1e-2, 1e-2, 1.0]) + 4.0 * np.array([0.2, 0.2, 1.0])
    q_w = np.concatenate([q_body, 0.3 * np.ones(3),
                          np.tile([0.2, 0.2, 1.0], 4)])
    obj = tracking_velocity_objective(dims, h_mpc, q=q_w, v=v_w,
                                      u=3e-3 * np.ones(dims.nu), dtype=dtype,
                                      device=card)
    mpc_ip = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                       undercut=5.0, gamma_reg=0.1, diff_sol=True, max_ls=3)
    sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                         undercut=float("inf"), max_ls=6, refine=1)
    q1, v1 = initial_conditions(ref)
    knot_ip.launches = 0
    out, wall = timed(lambda: mpc_rollout(
        model, env, ref, obj, steps, h_mpc, n_sample, kappa, CONFIGURATION,
        q1[None], v1[None],
        n_opts=NewtonOptions(r_tol=3e-5, max_iter=5, fixed_ip_iters=8),
        ip_opts=mpc_ip, sim_opts=sim_opts, warm_start_floor=1e-2), card)
    qe = float(tracking_errors(ref, out.q[0], out.u[0], out.gamma[0],
                               out.b[0], n_sample)[0])
    low, ref_low = float(out.q[0, :, 2].min()), float(ref.q[1, 2])
    with capsys.disabled():
        print(f"\n---- point-foot trot, {steps} steps: {wall:.2f} s, every "
              f"step converged {bool(out.sim_converged.all())}, q error "
              f"{qe:.5f} (< 0.05), lowest body height {low:.4f} (reference "
              f"{ref_low:.4f}), knot_ip launches {knot_ip.launches} "
              f"[{describe(card)}]", flush=True)
    assert bool(out.sim_converged.all())
    assert qe < 0.05, qe
    assert low > 0.5 * ref_low, (low, ref_low)
    assert knot_ip.launches >= steps // n_sample
