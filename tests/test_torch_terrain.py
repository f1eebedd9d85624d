"""The port's terrains against the JAX package, float64 on the CPU: every
entry of ``ENVIRONMENTS`` (the registry's keys, each terrain's dimension,
cone and friction mapping), and each terrain's surface, gradient and
contact-frame rotation at seeded points, among them both sides of every
break of the hard stairs and of the piecewise slopes.

Points are drawn with numpy from a seed and handed to both packages; JAX
maps its one-point functions over them. Tolerance 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contactimplicitmpc_tpu as ci

import contactimplicitmpc_tpu_torch as pt

# the breaks of the branchy terrains: points just below, at and just above
BREAKS = {"stairs3_2D_lc": (0.125, 0.375, 0.625, 0.875),
          "piecewise1_2D_lc": (0.4, 0.6, 1.9, 2.1),
          "piecewise2_2D_lc": (0.4, 0.6, 1.9, 2.1)}


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


def test_registry_matches():
    """The same 19 names; each terrain's dimension, cone, friction
    dimension and friction mapping equal to the JAX package's."""
    assert list(pt.ENVIRONMENTS) == list(ci.ENVIRONMENTS)
    assert len(pt.ENVIRONMENTS) == 19
    for name, env in pt.ENVIRONMENTS.items():
        jenv = ci.ENVIRONMENTS[name]
        assert (env.dim, env.cone, env.friction_dim) == \
            (jenv.dim, jenv.cone, jenv.friction_dim), name
        np.testing.assert_array_equal(
            env.friction_mapping(torch.float64).numpy(),
            np.asarray(jenv.friction_mapping(jnp.float64)), err_msg=name)


def _points(name, dim):
    rng = np.random.default_rng(sorted(ci.ENVIRONMENTS).index(name))
    if name == "circular_bowl_3D_nc":        # the bowl's rim is at radius 2.5
        return rng.uniform(-1.5, 1.5, (16, 2))
    x = rng.uniform(-0.5, 2.5, (16, dim - 1))
    if name in BREAKS:
        b = np.array(BREAKS[name])
        x = np.concatenate([x[:, 0], b - 1e-9, b, b + 1e-9])[:, None]
    return x


@pytest.mark.parametrize("name", list(ci.ENVIRONMENTS))
def test_terrain_matches(name):
    """Surface, gradient and rotation at the seeded points to 1e-12; the
    rotation takes the terrain's normal to the last axis."""
    env, jenv = pt.ENVIRONMENTS[name], ci.ENVIRONMENTS[name]
    x = _points(name, env.dim)
    jx = jnp.asarray(x)
    t = torch.as_tensor(x)
    want_s = jax.vmap(jenv.surf)(jx)
    want_g = jax.vmap(jenv.surf_grad)(jx)
    want_r = jax.vmap(jenv.rotation)(jx)
    got_s, got_g, got_r = env.surf(t), env.surf_grad(t), env.rotation(t)
    assert got_s.shape == (len(x),) and got_g.shape == x.shape
    assert got_r.shape == (len(x), env.dim, env.dim)
    for got, want, what in ((got_s, want_s, "surf"), (got_g, want_g, "grad"),
                            (got_r, want_r, "rotation")):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).reshape(got.shape),
                                   rtol=0, atol=1e-12, err_msg=what)
    n = torch.cat([-got_g, torch.ones_like(got_g[:, :1])], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    axis = np.zeros(env.dim)
    axis[-1] = 1.0
    np.testing.assert_allclose((got_r @ n[..., None])[..., 0].numpy(),
                               np.broadcast_to(axis, (len(x), env.dim)),
                               atol=1e-12)


def test_branches_at_the_breaks():
    """The stairs' declared gradient is zero everywhere (stairs.jl), and
    each branchy terrain takes the branch past a break only above it
    (strict ``<``), as the JAX package's ``jnp.where`` chains do."""
    b = torch.tensor([[0.125], [0.125 - 1e-9], [0.875], [0.875 + 1e-9]],
                     dtype=torch.float64)
    np.testing.assert_array_equal(pt.stairs3_2d_lc.surf(b).numpy(),
                                  [0.25, 0.0, 0.0, 0.0])
    assert not pt.stairs3_2d_lc.surf_grad(b).any()
    x = torch.tensor([[0.4 - 1e-9], [0.4]], dtype=torch.float64)
    g = pt.piecewise1_2d_lc.surf_grad(x)[:, 0]
    assert float(g[0]) == 0.0 and abs(float(g[1])) < 1e-12
    # the slope's kink: the piecewise terrain is continuous at its breaks
    for edge in BREAKS["piecewise1_2D_lc"]:
        pts = torch.tensor([[edge - 1e-9], [edge + 1e-9]], dtype=torch.float64)
        s = pt.piecewise1_2d_lc.surf(pts)
        assert abs(float(s[1] - s[0])) < 1e-6, edge
