"""The port's visuals (``utils/visuals.py``, ``utils/meshes.py``,
``utils/live.py``) against the JAX package's, on the CPU.

The geometry (skeletons, feet, force vectors, MRP rotations, body polygons
and faces) of seeded configurations, handed to the port as float64 tensors
and to the JAX package as numpy, agrees to 1e-12. The functions that write
files write non-empty ones from port tensors. ``simulate`` with a
``LivePlotter`` records what the JAX package's records, to 1e-12.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.models import MODELS as JMODELS
from contactimplicitmpc_tpu.models import particle_2d as jparticle
from contactimplicitmpc_tpu.utils import meshes as jmeshes
from contactimplicitmpc_tpu.utils import visuals as jvisuals
from contactimplicitmpc_tpu.utils.live import LivePlotter as JLivePlotter

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.models import MODELS
from contactimplicitmpc_tpu_torch.models.particle_2d import particle_2d
from contactimplicitmpc_tpu_torch.utils import meshes, visuals
from contactimplicitmpc_tpu_torch.utils.live import LivePlotter

TOL = 1e-12
PLANAR = ("hopper_2D", "quadruped", "flamingo", "pushbot", "walledcartpole",
          "particle_2D")
SPATIAL = ("centroidal_quadruped", "hopper_3D", "point_foot_quadruped",
           "centroidal_quadruped_wall")


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


def configuration(name, seed=0):
    """A seeded configuration of the model ``name``: a standing pose (3D:
    body 0.3 up, feet at the corners of a 0.4 × 0.3 rectangle) moved by
    0.1 · N(0, 1) (the attitude by 0.05)."""
    rng = np.random.default_rng(seed)
    nq = MODELS[name].nq
    q = 0.1 * rng.standard_normal(nq)
    if name == "hopper_2D":
        q += [0.0, 0.6, 0.0, 0.5]
    elif name == "quadruped":
        q += [0.0, 0.3, 1.57, -0.5, 0.3, -0.6, 0.4, -0.55, 0.35, -0.6, 0.45]
    elif name == "flamingo":
        q += [0.0, 0.8, 0.0, 0.3, -0.6, -0.3, 0.6, 1.57, 1.57]
    elif name == "hopper_3D":
        q += [0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.5]
        q[3:6] *= 0.5
    elif name in SPATIAL:
        q[:3] += [0.0, 0.0, 0.3]
        q[3:6] *= 0.5
        for i, (fx, fy) in enumerate([(0.2, 0.15), (0.2, -0.15),
                                      (-0.2, 0.15), (-0.2, -0.15)]):
            q[6 + 3 * i:9 + 3 * i] += [fx, fy, 0.0]
    return q


def tensor(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def assert_lines(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)


# ---- geometry against the JAX package ---------------------------------------

@pytest.mark.parametrize("name", PLANAR)
def test_skeleton_2d_matches(name):
    q = configuration(name)
    assert_lines(visuals.skeleton_2d(MODELS[name], tensor(q)),
                 jvisuals.skeleton_2d(JMODELS[name], q))


@pytest.mark.parametrize("name", PLANAR)
def test_contact_force_vectors_match(name):
    q = configuration(name, 1)
    rng = np.random.default_rng(2)
    nc = MODELS[name].nc
    gamma, b = rng.uniform(0, 1, nc), rng.uniform(0, 1, 2 * nc)
    got = visuals.contact_force_vectors(MODELS[name], tensor(q),
                                        tensor(gamma), tensor(b))
    want = jvisuals.contact_force_vectors(JMODELS[name], q, gamma, b)
    assert_lines(got, want)


@pytest.mark.parametrize("name", PLANAR)
def test_body_polygons_2d_match(name):
    q = configuration(name, 3)
    got = meshes.body_polygons_2d(MODELS[name], tensor(q))
    want = jmeshes.body_polygons_2d(JMODELS[name], q)
    assert [c for _, c in got] == [c for _, c in want]
    assert_lines([p for p, _ in got], [p for p, _ in want])


@pytest.mark.parametrize("name", SPATIAL)
def test_skeleton_3d_and_feet_match(name):
    q = configuration(name, 4)
    assert_lines(visuals.skeleton_3d(MODELS[name], tensor(q)),
                 jvisuals.skeleton_3d(JMODELS[name], q))
    np.testing.assert_allclose(visuals.feet_3d(MODELS[name], tensor(q)),
                               jvisuals.feet_3d(JMODELS[name], q), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", SPATIAL)
def test_body_faces_3d_match(name):
    q = configuration(name, 5)
    got = meshes.body_faces_3d(MODELS[name], tensor(q))
    want = jmeshes.body_faces_3d(JMODELS[name], q)
    assert [c for _, c in got] == [c for _, c in want]
    for (faces, _), (jfaces, _) in zip(got, want):
        assert_lines(faces, jfaces)


def test_mrp_rotation_matches():
    rng = np.random.default_rng(6)
    for p in 0.3 * rng.standard_normal((5, 3)):
        got = meshes.mrp_rotation(tensor(p))
        np.testing.assert_allclose(got, jmeshes.mrp_rotation(p), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-12)


# ---- files written from port tensors ----------------------------------------

@pytest.fixture(scope="module")
def hopper_traj():
    """30 steps of the 2D hopper dropped from 0.6, two lanes (port)."""
    q1 = tensor([[0.0, 0.6, 0.0, 0.5], [0.1, 0.6, 0.05, 0.5]])
    return pt.simulate(MODELS["hopper_2D"], pt.flat_2d_lc, 30, 0.01, q1,
                       torch.zeros_like(q1))


def nonempty(path):
    return os.path.exists(path) and os.path.getsize(path) > 0


def test_export_and_plots(tmp_path, hopper_traj):
    p = visuals.export_trajectory(str(tmp_path / "traj.npz"), hopper_traj)
    with np.load(p) as f:
        assert f["q"].shape == (2, 32, 4)
        np.testing.assert_array_equal(f["q"], hopper_traj.q.numpy())
    assert nonempty(visuals.plot_tracking(
        hopper_traj.q[0], hopper_traj.q[0, :10],
        path=str(tmp_path / "t.png")))
    assert nonempty(visuals.plot_contacts(hopper_traj.gamma[0],
                                          path=str(tmp_path / "c.png")))


def test_animations_2d(tmp_path, hopper_traj):
    model = MODELS["hopper_2D"]
    w = torch.zeros((30, 2), dtype=torch.float64)
    w[10:13, 0] = 1.0
    assert nonempty(visuals.animate_2d(
        model, hopper_traj.q[0], env=pt.flat_2d_lc,
        path=str(tmp_path / "roll.gif"), every=6,
        gamma=hopper_traj.gamma[0], b=hopper_traj.b[0], w=w, payload=3.0))
    assert nonempty(meshes.animate_mesh_2d(
        model, hopper_traj.q[0], pt.flat_2d_lc,
        path=str(tmp_path / "mesh.gif"), every=6,
        gamma=hopper_traj.gamma[0]))
    assert nonempty(visuals.plot_runs_2d(
        model, hopper_traj.q, env=pt.slope_smooth_2d_lc,
        path=str(tmp_path / "runs.png"), stride=10))


def test_animations_3d_and_stills(tmp_path):
    model = MODELS["centroidal_quadruped"]
    qs = tensor(np.tile(configuration("centroidal_quadruped"), (6, 1)))
    qs[:, 2] += torch.linspace(0.0, 0.05, 6, dtype=torch.float64)
    gamma = torch.full((6, 4), 0.3, dtype=torch.float64)
    assert nonempty(visuals.animate_3d(
        model, qs, env=pt.sine1_3d_lc, path=str(tmp_path / "r3.gif"),
        every=2, gamma=gamma))
    assert nonempty(meshes.animate_mesh_3d(
        model, qs, path=str(tmp_path / "m3.gif"), every=2))
    assert nonempty(meshes.render_still(model, qs[0],
                                        path=str(tmp_path / "s3.png")))
    assert nonempty(meshes.render_still(
        MODELS["quadruped"], tensor(configuration("quadruped")),
        pt.flat_2d_lc, path=str(tmp_path / "s2.png")))


# ---- the live plotter --------------------------------------------------------

def test_live_plotter_matches_jax(tmp_path):
    """30 steps of the 2D particle sliding at 2 m/s from height 1: the
    port's plotter keeps lane 0 of two and records JAX's (t, q, u, γ)."""
    jlp = JLivePlotter(every=10, path=str(tmp_path / "jlive.png"))
    jtraj = jax.jit(lambda q, v: ci.simulate(
        jparticle, ci.flat_2d_lc, 30, 0.01, q, v, live_plotter=jlp))(
        jnp.array([0.0, 1.0]), jnp.array([2.0, 0.0]))
    jax.block_until_ready(jtraj.q)

    ref_q = tensor(np.linspace([0.0, 1.0], [0.6, 0.0], 8))
    lp = LivePlotter(ref_q=ref_q, n_sample=5, every=10,
                     path=str(tmp_path / "live.png"))
    traj = pt.simulate(particle_2d, pt.flat_2d_lc, 30, 0.01,
                       tensor([[0.0, 1.0], [0.5, 0.5]]),
                       tensor([[2.0, 0.0], [0.0, 0.0]]), live_plotter=lp)
    assert lp.ts == jlp.ts == list(range(30))
    for mine, theirs in ((lp.qs, jlp.qs), (lp.us, jlp.us),
                         (lp.gammas, jlp.gammas)):
        np.testing.assert_allclose(np.stack(mine), np.stack(theirs), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(np.stack(lp.qs), traj.q[0, 2:].numpy(),
                               rtol=0, atol=0)
    assert lp.flush() is not None
    assert os.path.getsize(tmp_path / "live.png") > 5000
