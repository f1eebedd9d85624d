"""The Newton's two KKT kernels on the CPU: ``csrc/structure_kkt.cu`` (the
structure mode's whole structured KKT solve, ``ops/structure_kkt.py``) and
``csrc/ldl.cu`` (the direct mode's unpivoted LDLᵀ solve, ``ops/ldl.py``).

There is no card here, so what is held is what the CPU can hold:

- the routes: a pure function of the tensors' device, type and dimensions,
  the plain version on CPU tensors (the LDLᵀ's wrapper runs it, bit for
  bit; the structured solve's raises, its caller runs it), the kernel for
  every model's (nq, nu, H) and every direct path's n on the card, a raise
  past what the source holds; the wrappers' constants are the source's;
- the launch geometry: a block's shared bytes, from the source's own
  ``shared_values`` at its constants, equal the wrappers' and fit an
  H100's 227 KB for every model and H ≤ 20 and for n ≤ 480, both types;
- the kernels' schedules, transcribed into PyTorch step for step (the
  LDLᵀ's panels of 32 columns, their trailing updates in the order of k and
  the substitutions by blocks of 32; the structured solve's stage-by-stage
  Y assembly, Cholesky column steps by the pivot's reciprocal, Lⱼᵢ, the
  forward substitution folded into the sweep, the backward substitution and
  the recovery), held to the JAX package in float64: SQD matrices at n = 100
  and 480 against ``ldl_solve`` to 1e-10 relative (and the factor equal to
  the port's plain one bit for bit, as the kernel's is), and a quadruped
  structure KKT at H = 10 against ``structure_kkt_solve`` to 1e-10.

On the card ``tests/test_torch_kkt_cuda.py`` holds the kernels themselves.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contactimplicitmpc_tpu.control import structure_solver as jss
from contactimplicitmpc_tpu.dims import Dims as JDims
from contactimplicitmpc_tpu.ops import linsolve as jl

import contactimplicitmpc_tpu_torch as pt
from contactimplicitmpc_tpu_torch.control import structure_solver as ss
from contactimplicitmpc_tpu_torch.hotpath import HotPathConfig
from contactimplicitmpc_tpu_torch.models import MODELS
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.ops import ldl as ldl_mod
from contactimplicitmpc_tpu_torch.ops import structure_kkt as sk_mod
from contactimplicitmpc_tpu_torch.ops.ldl import ldl
from contactimplicitmpc_tpu_torch.ops.linsolve import (_boost_pivot,
                                                       ldl_factor, ldl_solve)
from contactimplicitmpc_tpu_torch.ops.structure_kkt import structure_kkt

F64 = torch.float64
DIRECT_N = (100, 300, 340, 360, 480)   # paths B; C and L; F; E; D, I and K
HORIZONS = range(3, 21)


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


def source_constants(path):
    with open(path) as f:
        src = f.read()
    consts = {}
    for k, v in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        consts[k] = eval(v.replace("/", "//"), {}, consts)
    values = re.search(r"constexpr int shared_values\([^)]*\) \{\s*"
                       r"return ([^;]*);", src).group(1)
    return consts, " ".join(values.split())


def sqd(rng, batch, n, m):
    """``batch`` symmetric quasidefinite matrices [P Bᵀ; B −R], P (n − m)²
    positive definite, R m² positive definite."""
    p = rng.standard_normal((batch, n - m, n - m))
    p = p @ np.swapaxes(p, -1, -2) / (n - m) + np.eye(n - m)
    r = rng.standard_normal((batch, m, m))
    r = r @ np.swapaxes(r, -1, -2) / m + 1e-2 * np.eye(m)
    b = 0.3 * rng.standard_normal((batch, m, n - m))
    return np.concatenate([np.concatenate([p, np.swapaxes(b, -1, -2)], -1),
                           np.concatenate([b, -r], -1)], -2)


# ---- (a) the routes ------------------------------------------------------------

def test_routes_are_the_sources_and_cover_every_model_and_path():
    consts, _ = source_constants(sk_mod.SOURCE)
    assert (consts["kThreads"], consts["kMaxN"], consts["kMaxNu"],
            consts["kMinH"], consts["kSharedLimit"]) == (
        sk_mod.THREADS, sk_mod.MAX_N, sk_mod.MAX_NU, sk_mod.MIN_H,
        sk_mod.SHARED_LIMIT)
    consts, _ = source_constants(ldl_mod.SOURCE)
    assert (consts["kThreads"], consts["kPanel"], consts["kMaxN"],
            consts["kSharedLimit"]) == (ldl_mod.THREADS, ldl_mod.PANEL,
                                        ldl_mod.MAX_N, ldl_mod.SHARED_LIMIT)
    cuda = torch.device("cuda")
    for dtype in (torch.float32, F64):
        for model in MODELS.values():
            for h in HORIZONS:
                assert sk_mod.route("cpu", dtype, model.nq, model.nu, h) == \
                    "plain"
                assert sk_mod.route(cuda, dtype, model.nq, model.nu, h) == \
                    "cuda"
        for n in DIRECT_N:
            assert ldl_mod.route("cpu", dtype, n) == "plain"
            assert ldl_mod.route(cuda, dtype, n) == "cuda"
    for dims in ((33, 8, 10), (11, 65, 10), (11, 8, 2), (32, 64, 200)):
        with pytest.raises(ValueError):
            sk_mod.route(cuda, torch.float32, *dims)
    for n in (0, ldl_mod.MAX_N + 1):
        with pytest.raises(ValueError):
            ldl_mod.route(cuda, torch.float32, n)
    for dtype in (torch.float16, torch.int32):
        with pytest.raises(ValueError):
            sk_mod.route(cuda, dtype, 11, 8, 10)
        with pytest.raises(ValueError):
            ldl_mod.route(cuda, dtype, 300)


def structure_case(seed, lanes=2, h=10):
    """A quadruped structure KKT at H = 10: the hot path's structure
    objective and seeded stage Jacobians and residuals, as numpy arrays."""
    dims = dims_of(quadruped, pt.flat_2d_lc)
    nq, nu = dims.nq, dims.nu
    sobj = ss.structure_objective_from_tracking(
        dims, pt.hotpath.quadruped_tracking_weights(dims, h, F64, "cpu"),
        HotPathConfig().newton_options().beta_init, h)
    rng = np.random.default_rng(seed)
    shapes = dict(aa=(h, nq, nq), ab=(h, nq, nq), ba=(h, nq, nu),
                  rlagu=(h, nu), rlagqa=(h, nq), rlagqb=(h, nq),
                  rdyn1=(h, nq), rdyn2=(h, nq))
    data = {k: rng.standard_normal((lanes,) + s) * (0.3 if k[0] in "ab"
                                                   else 1.0)
            for k, s in shapes.items()}
    return dims, sobj, data


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(2)
    a, b = torch.as_tensor(sqd(rng, 3, 40, 15)), torch.as_tensor(
        rng.standard_normal((3, 40)))
    before = ldl.launches
    assert torch.equal(ldl(a, b), ldl_solve(a, b))
    # the structured solve's plain version is the caller's: the Newton
    # solve takes it on CPU tensors, and the wrapper raises on them
    dims, sobj, data = structure_case(3)
    args = [torch.as_tensor(x) for x in data.values()]
    assert sk_mod.route(args[0].device, F64, dims.nq, dims.nu, 10) == "plain"
    with pytest.raises(ValueError, match="CUDA tensors"):
        structure_kkt(dims, sobj, *args, 1e-5, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk_mod.structure_kkt_factors(dims, sobj, *args, 1e-5, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ldl_mod.ldl_factors(a, b)
    assert (ldl.launches, structure_kkt.launches) == (before, 0)


# ---- (b) the launch geometry ----------------------------------------------------

def test_launch_geometry_fits_and_matches_the_source():
    """A block's shared bytes, the source's ``shared_values`` evaluated at
    its constants, are the wrappers' and fit 227 KB: the structured solve
    for every model's (nq, nu) at H ≤ 20, the LDLᵀ for n ≤ 480 (and the
    source's largest n), in float32 and float64."""
    consts, values = source_constants(sk_mod.SOURCE)
    for elem in (4, 8):
        for model in MODELS.values():
            for h in HORIZONS:
                env = dict(nq=model.nq, nu=model.nu, ns=h - 1)
                size = elem * eval(values, {}, env)
                assert size == sk_mod.shared_bytes(model.nq, model.nu, h, elem)
                assert size <= consts["kSharedLimit"] == 227 * 1024
    consts, values = source_constants(ldl_mod.SOURCE)
    for elem in (4, 8):
        for n in (*range(1, 481), consts["kMaxN"]):
            size = elem * eval(values, {}, dict(consts, n=n))
            assert size == ldl_mod.shared_bytes(n, elem)
            assert size <= consts["kSharedLimit"]


# ---- (c) the kernels' schedules against JAX ------------------------------------

def ldl_schedule(a, b, panel=32, block=32):
    """``csrc/ldl.cu``'s schedule: panels of ``panel`` columns, each factored
    a column at a time (scale the column by its floored pivot; update the
    panel's later columns), then the trailing lower triangle takes the
    panel's updates in the order of k; L y = b and Lᵀ x = y / d a block of
    ``block`` rows at a time (the diagonal block a column at a time, the
    rest in the order of the block's columns). Returns (x, L, d)."""
    n = a.shape[-1]
    boost = torch.finfo(a.dtype).tiny
    w = a.clone()
    d = torch.empty(a.shape[:-1], dtype=a.dtype)
    for p0 in range(0, n, panel):
        q0 = min(p0 + panel, n)
        for kk in range(p0, q0):
            piv = _boost_pivot(w[:, kk, kk], boost)
            d[:, kk] = piv
            w[:, kk + 1:, kk] = w[:, kk + 1:, kk] / piv[:, None]
            w[:, kk + 1:, kk + 1:q0] -= ((piv[:, None] * w[:, kk + 1:, kk])
                                         [:, :, None]
                                         * w[:, kk + 1:q0, kk][:, None, :])
        for kk in range(p0, q0):
            w[:, q0:, q0:] -= ((d[:, kk, None] * w[:, q0:, kk])[:, :, None]
                               * w[:, q0:, kk][:, None, :])
    low = torch.tril(w, -1) + torch.eye(n, dtype=a.dtype)
    r = b.clone()
    for p0 in range(0, n, block):
        q0 = min(p0 + block, n)
        for k in range(p0, q0):
            r[:, k + 1:q0] -= low[:, k + 1:q0, k] * r[:, k:k + 1]
        for k in range(p0, q0):
            r[:, q0:] -= low[:, q0:, k] * r[:, k:k + 1]
    r = r / _boost_pivot(d, boost)
    for p1 in range(n, 0, -block):
        p0 = max(0, p1 - block)
        for k in range(p1 - 1, p0 - 1, -1):
            r[:, p0:k] -= low[:, k, p0:k] * r[:, k:k + 1]
        for k in range(p0, p1):
            r[:, :p0] -= low[:, k, :p0] * r[:, k:k + 1]
    return r, low, d


@pytest.mark.parametrize("n, m", [(100, 40), (480, 180)])
def test_ldl_schedule_matches_jax(n, m):
    rng = np.random.default_rng(n)
    a, b = sqd(rng, 2, n, m), rng.standard_normal((2, n))
    x, low, d = ldl_schedule(torch.as_tensor(a), torch.as_tensor(b))
    l_plain, d_plain = ldl_factor(torch.as_tensor(a))
    assert torch.equal(low, l_plain) and torch.equal(d, d_plain)
    want = np.stack([np.asarray(jl.ldl_solve(jnp.asarray(a[i]),
                                             jnp.asarray(b[i])))
                     for i in range(2)])
    scale = np.abs(want).max()
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-10 * scale)


def structure_schedule(obj, aa, ab, ba, ru, rqa, rqb, rd1, rd2, beta, h):
    """``csrc/structure_kkt.cu``'s schedule a stage at a time: W = [aa ab]
    Q, V = ba R⁻¹ and Yij; Yii's lower triangle less Pᵀ P (P the stage
    before's Lⱼᵢ) and β; the Cholesky a column step at a time by the
    pivot's reciprocal, NaN in the lower triangle where a pivot is not > 0;
    Lⱼᵢ = L⁻¹ Yij a column at a time; y folded into the sweep; then the
    backward substitution and the recovery. Returns the five padded steps
    and (Lᵢᵢ, Lⱼᵢ)."""
    batch, nq, nu = aa.shape[0], aa.shape[-1], ba.shape[-1]
    n, ns = 2 * nq, h - 1
    eye = torch.eye(nq, dtype=aa.dtype)
    mv = lambda m, v: (m @ v[..., None])[..., 0]
    lii, lji, ys = [], [], []
    prev = None
    for st in range(ns):
        t = st + 1
        mask = 1.0 if st > 0 else 0.0
        a, b_, bam = aa[:, t], ab[:, t], ba[:, t]
        qac, qbc, qvc = obj.qat[t], obj.qbt[t], obj.qvt[t]
        qan, qbn, qvn = obj.qat[t + 1], obj.qbt[t + 1], obj.qvt[t + 1]
        ra = obj.rat[t]
        zero = torch.zeros_like(rqa[:, t])
        rqap = rqa[:, t - 1] if st > 0 else zero
        rqbp = rqb[:, t - 1] if st > 0 else zero
        w = torch.cat([a @ qac + b_ @ qvc, a @ qvc + b_ @ qbc], -1)
        v = bam @ ra
        if st < ns - 1:
            an, bn = aa[:, t + 1], ab[:, t + 1]
            yij = torch.cat([
                torch.cat([(-qvn).expand(batch, nq, nq),
                           -(qan @ an.mT + qvn @ bn.mT)], -1),
                torch.cat([(-qbn).expand(batch, nq, nq),
                           -(qvn @ an.mT + qbn @ bn.mT)], -1)], -2)
        g = mv(ra, ru[:, t])
        pa, pb, pc, pd = mv(qac, rqap), mv(qbc, rqbp), mv(qvc, rqbp), \
            mv(qvc, rqap)
        yiia = (qan + mask * qbc + beta * eye).expand(batch, nq, nq)
        yiic = qvn + mask * w[..., nq:]
        yiid = (qbn + v @ bam.mT + mask * (w[..., :nq] @ a.mT
                                          + w[..., nq:] @ b_.mT)
                + beta * eye)
        yii = torch.cat([torch.cat([yiia, yiic.mT], -1),
                         torch.cat([yiic, yiid], -1)], -2)
        m = torch.tril(yii if prev is None else yii - prev.mT @ prev)
        beta1 = -rd1[:, t] + mv(qan, rqa[:, t]) + mv(qvn, rqb[:, t]) \
            - mask * (pb + pd)
        beta2 = (-rd2[:, t] - mv(bam, g) + mv(qbn, rqb[:, t])
                 + mv(qvn, rqa[:, t])
                 - mask * (mv(a, pa) + mv(b_, pb) + mv(a, pc) + mv(b_, pd)))
        rhs = torch.cat([beta1, beta2], -1)
        low = torch.zeros_like(m)
        bad = torch.zeros(batch, dtype=torch.bool)
        for k in range(n):
            dk = m[:, k, k]
            bad |= ~(dk > 0)
            lkk = torch.sqrt(dk)
            r = 1.0 / lkk
            low[:, k, k] = lkk
            c = m[:, k + 1:, k] * r[:, None]
            low[:, k + 1:, k] = c
            m[:, k + 1:, k + 1:] -= c[:, :, None] * c[:, None, :]
        low = torch.where(bad[:, None, None],
                          torch.full_like(low, float("nan")).tril(), low)
        lii.append(low)
        if st < ns - 1:
            for i in range(n):
                yij[:, i] = (yij[:, i] - (low[:, i, :i, None] * yij[:, :i])
                             .sum(1)) / low[:, i, i, None]
            lji.append(yij)
        if prev is not None:
            rhs = rhs - mv(prev.mT, ys[-1])
        for k in range(n):
            rhs[:, k] = rhs[:, k] / low[:, k, k]
            rhs[:, k + 1:] -= low[:, k + 1:, k] * rhs[:, k:k + 1]
        ys.append(rhs)
        prev = yij if st < ns - 1 else None
    xs = [None] * ns
    for st in reversed(range(ns)):
        r = ys[st] if st == ns - 1 else ys[st] - mv(lji[st], xs[st + 1])
        r = r.clone()
        for k in reversed(range(n)):
            r[:, k] = r[:, k] / lii[st][:, k, k]
            r[:, :k] -= lii[st][:, k, :k] * r[:, k:k + 1]
        xs[st] = r
    out = {k: [torch.zeros((batch, w), dtype=aa.dtype)] for k, w in
           (("du", nu), ("dqa", nq), ("dqb", nq), ("dnu1", nq), ("dnu2", nq))}
    for st in range(ns):
        t, x = st + 1, xs[st]
        if st < ns - 1:
            xn = xs[st + 1]
            va = mv(aa[:, t + 1].mT, xn[:, nq:])
            vb = mv(ab[:, t + 1].mT, xn[:, nq:])
            nu1 = xn[:, :nq]
        else:
            va = vb = nu1 = torch.zeros_like(x[:, :nq])
        ea = rqa[:, t] - x[:, :nq] + va
        eb = rqb[:, t] - x[:, nq:] + vb + nu1
        vu = ru[:, t] + mv(ba[:, t].mT, x[:, nq:])
        out["du"].append(mv(obj.rat[t], vu))
        out["dqa"].append(mv(obj.qat[t + 1], ea) + mv(obj.qvt[t + 1], eb))
        out["dqb"].append(mv(obj.qbt[t + 1], eb) + mv(obj.qvt[t + 1], ea))
        out["dnu1"].append(x[:, :nq])
        out["dnu2"].append(x[:, nq:])
    steps = tuple(torch.stack(v, 1) for v in out.values())
    return steps, (torch.stack(lii, 1), torch.stack(lji, 1))


def test_structure_schedule_matches_jax():
    """The quadruped's structure KKT at H = 10, two lanes: the schedule's
    steps against JAX's ``structure_kkt_solve`` (and its factors against
    the port's plain sweep) to 1e-10; with β = −10³ every first block is
    not positive definite, and the schedule's factor is NaN where the plain
    version's is."""
    dims, sobj, data = structure_case(11)
    h = 10
    args = [torch.as_tensor(x) for x in data.values()]
    steps, (lii, lji) = structure_schedule(sobj, *args, 1e-5, h)
    jd = JDims(**dataclasses.asdict(dims))
    jobj = jss.StructureObjective(*(jnp.asarray(x.numpy()) for x in sobj))
    for b in range(2):
        want = jss.structure_kkt_solve(
            jd, jobj, *(jnp.asarray(x[b]) for x in data.values()), 1e-5, h)
        for g, w in zip(steps, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g[b].numpy(), w, rtol=0,
                                       atol=1e-10 * np.abs(w).max())
    yii, yij = ss.compute_y_blocks(sobj, *args[:3], 1e-5, h)
    want_l, want_j = ss.block_tridiag_cholesky(yii, yij)
    np.testing.assert_allclose(lii.numpy(), want_l.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(lji.numpy(), want_j.numpy(), rtol=0,
                               atol=1e-10)

    steps, (lii, _) = structure_schedule(sobj, *args, -1e3, h)
    yii, yij = ss.compute_y_blocks(sobj, *args[:3], -1e3, h)
    want_l, _ = ss.block_tridiag_cholesky(yii, yij)
    assert torch.equal(torch.isnan(lii), torch.isnan(want_l))
    assert torch.isnan(lii[:, 0].diagonal(dim1=-2, dim2=-1)).all()
    assert not any(torch.isfinite(s[:, 1:]).all() for s in steps)
