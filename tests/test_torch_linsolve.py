"""The port's small dense solvers (``ops/linsolve.py``) against the JAX
package's, float64 on the CPU, on batches of seeded numpy matrices: the
Gauss-Jordan inverse and solve, the unpivoted LDLᵀ factors (L, d and the
boosted pivot carried in d) and solve, and the modified Gram-Schmidt QR.
Both packages run the same elimination order, so they agree to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contactimplicitmpc_tpu.ops import linsolve as jl

from contactimplicitmpc_tpu_torch.ops import linsolve as tl

TOL = dict(rtol=1e-10, atol=1e-12)


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


def sqd(rng, batch, n, m):
    """Symmetric quasidefinite matrices [[H, Aᵀ], [A, −βI]], the shape of
    the Newton KKT."""
    h = rng.standard_normal((batch, n, n))
    h = h @ h.transpose(0, 2, 1) + np.eye(n)
    a = rng.standard_normal((batch, m, n))
    top = np.concatenate([h, a.transpose(0, 2, 1)], axis=2)
    bot = np.concatenate([a, -0.1 * np.broadcast_to(np.eye(m), (batch, m, m))],
                         axis=2)
    return np.concatenate([top, bot], axis=1)


def t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("n,m", [(4, 2), (12, 7)])
def test_ldl_factor_matches(n, m):
    a = sqd(np.random.default_rng(0), 3, n, m)
    want_l, want_d = jax.vmap(jl.ldl_factor)(jnp.asarray(a))
    got_l, got_d = tl.ldl_factor(t(a))
    np.testing.assert_allclose(got_l.numpy(), want_l, **TOL)
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)
    # L diag(d) Lᵀ gives the matrix back
    back = got_l @ torch.diag_embed(got_d) @ got_l.mT
    np.testing.assert_allclose(back.numpy(), a, rtol=1e-9, atol=1e-9)


def test_ldl_boost_is_carried_in_d():
    """A zero pivot is floored at ``boost`` with the pivot's sign, and d
    carries the floored value that scaled L's column."""
    a = np.array([[[0.0, 1.0, 0.5], [1.0, 2.0, 0.3], [0.5, 0.3, -1.0]]])
    want_l, want_d = jax.vmap(lambda x: jl.ldl_factor(x, 1e-3))(jnp.asarray(a))
    got_l, got_d = tl.ldl_factor(t(a), 1e-3)
    assert float(got_d[0, 0]) == 1e-3
    np.testing.assert_allclose(got_l.numpy(), want_l, **TOL)
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)


@pytest.mark.parametrize("cols", [None, 3])
def test_ldl_solve_matches(cols):
    rng = np.random.default_rng(1)
    a = sqd(rng, 4, 9, 5)
    b = rng.standard_normal((4, 14) if cols is None else (4, 14, cols))
    want = jax.vmap(jl.ldl_solve)(jnp.asarray(a), jnp.asarray(b))
    got = tl.ldl_solve(t(a), t(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(
        a, b if cols else b[..., None]).reshape(b.shape), rtol=1e-8, atol=1e-9)


def test_mgs_qr_and_solve_match():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 8, 8)) + 3 * np.eye(8)
    b = rng.standard_normal((3, 8))
    want_q, want_r = jax.vmap(jl.mgs_qr)(jnp.asarray(a))
    got_q, got_r = tl.mgs_qr(t(a))
    np.testing.assert_allclose(got_q.numpy(), want_q, **TOL)
    np.testing.assert_allclose(got_r.numpy(), want_r, **TOL)
    want = jax.vmap(jl.mgs_solve)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(tl.mgs_solve(t(a), t(b)).numpy(), want,
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("boost", [0.0, 1e-6])
def test_gj_inverse_and_solve_match(boost):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 6, 6)) + 4 * np.eye(6)
    if boost:
        a[0, 0, 0] = 0.0                   # a pivot that needs the floor
    b = rng.standard_normal((5, 6, 2))
    want = jax.vmap(lambda x: jl.gj_inverse(x, boost))(jnp.asarray(a))
    np.testing.assert_allclose(tl.gj_inverse(t(a), boost).numpy(), want,
                               rtol=1e-9, atol=1e-9)
    want = jax.vmap(lambda x, y: jl.gj_solve(x, y, boost))(
        jnp.asarray(a[1:]), jnp.asarray(b[1:]))
    np.testing.assert_allclose(tl.gj_solve(t(a[1:]), t(b[1:]), boost).numpy(),
                               want, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("cols", [None, 3])
def test_gj_factor_and_apply_match(cols):
    """The public factor handle: ``gj_factor`` stores the inverse and
    ``gj_apply`` multiplies by it, a vector or a matrix of right-hand
    sides; to 1e-12."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((4, 7, 7)) + 4 * np.eye(7)
    b = rng.standard_normal((4, 7) if cols is None else (4, 7, cols))
    # GJFactors is no pytree: the JAX side maps the handle's use
    want_inv = jax.vmap(lambda x: jl.gj_factor(x).inv)(jnp.asarray(a))
    got_f = tl.gj_factor(t(a))
    assert isinstance(got_f, tl.GJFactors)
    np.testing.assert_allclose(got_f.inv.numpy(), want_inv, rtol=0,
                               atol=1e-12)
    want = jax.vmap(lambda x, y: jl.gj_apply(jl.gj_factor(x), y))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(tl.gj_apply(got_f, t(b)).numpy(), want,
                               rtol=0, atol=1e-12)
