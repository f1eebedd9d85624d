"""The Newton's two KKT kernels on the CPU: ``csrc/structure_kkt.cu`` (the
structure mode's whole structured KKT solve, ``ops/structure_kkt.py``) and
``csrc/ldl.cu`` (the direct mode's unpivoted LDLᵀ solve, ``ops/ldl.py``).

There is no card here, so what is held is what the CPU can hold:

- the routes: a pure function of the tensors' device, type and dimensions,
  the plain version on CPU tensors (the LDLᵀ's wrapper runs it, bit for
  bit; the structured solve's raises, its caller runs it), the kernel for
  every model's (nq, nu, H) and every direct path's n on the card, a raise
  past what the source holds; the wrappers' constants are the source's;
- the launch geometry, from the source's own constexpr functions evaluated
  at its constants: the LDLᵀ's cluster (the source's rule, the smallest of
  4, 8 and 16 CTAs whose shared memory holds the matrix), its rows and
  shared bytes a CTA, equal to the wrappers' and within an H100's 227 KB
  for every n ≤ 480 and the source's largest n (≥ 480), both types; the
  structured solve's chunk of stages (the source's rule: every stage where
  they fit, else the most that fit) and its shared bytes for every model's
  (nq, nu) at H ≤ 20, both types, every stage in one chunk at path A's;
- the kernels' schedules, transcribed into PyTorch step for step (the
  LDLᵀ's panels of 32 columns: the diagonal block a column at a time with
  its rows' forward substitution, every row below eliminated on its own,
  the trailing update in the order of k, the backward substitution a block
  of 32 rows at a time from the cluster's partial sums; the structured
  solve's prologue over every stage, then its chain a stage at a time: M
  and y's right-hand side, the Cholesky column steps by the pivot's
  reciprocal square root, Lⱼᵢ and y column by column, then the backward
  substitution and the recovery), held to the JAX package in float64: SQD
  matrices at n = 100 and 480 against ``ldl_solve`` to 1e-10 relative (and
  the factor equal to the port's plain one bit for bit, as the kernel's
  is), and a quadruped structure KKT at H = 10 against
  ``structure_kkt_solve`` to 1e-10.

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
    """The source's integer constants, and its one-line constexpr functions
    (``constexpr int f(int a, ...) { return <expression>; }`` without a
    conditional) as Python functions of the same arguments, C's integer
    division on the nonnegative values they take; and the source's text."""
    with open(path) as f:
        src = f.read()
    consts = {}
    for k, v in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        consts[k] = eval(v.replace("/", "//"), {}, consts)
    funcs = dict(consts)
    for name, args, expr in re.findall(
            r"constexpr int (\w+)\(([^)]*)\) \{\s*return ([^;?]*);\s*\}", src):
        params = ", ".join(a.split()[-1] for a in args.split(","))
        body = " ".join(expr.split()).replace("/", "//")
        funcs[name] = eval(f"lambda {params}: {body}", funcs)
    return consts, funcs, src


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
    consts, _, _ = source_constants(sk_mod.SOURCE)
    assert (consts["kThreads"], consts["kMaxN"], consts["kMaxNu"],
            consts["kMinH"], consts["kSharedLimit"]) == (
        sk_mod.THREADS, sk_mod.MAX_N, sk_mod.MAX_NU, sk_mod.MIN_H,
        sk_mod.SHARED_LIMIT)
    consts, _, _ = source_constants(ldl_mod.SOURCE)
    assert (consts["kThreads"], consts["kPanel"], consts["kCluster"],
            consts["kTileCols"], consts["kLd"], consts["kMaxN"],
            consts["kSharedLimit"]) == (
        ldl_mod.THREADS, ldl_mod.PANEL, ldl_mod.CLUSTER, ldl_mod.TILE_COLS,
        ldl_mod.LD, ldl_mod.MAX_N, ldl_mod.SHARED_LIMIT)
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
    """The geometry from the source's own functions at its constants: the
    LDLᵀ's cluster by the source's rule (the smallest of kCluster, 2 and 4
    kCluster CTAs whose shared memory holds the matrix), a CTA's rows and
    shared bytes, equal to the wrappers' and within 227 KB for n ≤ 480 and
    the source's largest n, which is at least 480; the structured solve's
    chunk by the source's rule (every stage where they fit, else the most
    that fit) and its shared bytes for every model's (nq, nu) at H ≤ 20,
    equal to the wrappers' and within 227 KB, every stage in one chunk at
    path A's (nq 11, nu 8, H 10). Float32 and float64."""
    consts, f, src = source_constants(ldl_mod.SOURCE)
    limit, c4 = consts["kSharedLimit"], consts["kCluster"]
    assert limit == 227 * 1024 and consts["kMaxN"] >= 480 and c4 == 4
    assert "return elem_bytes * shared_values(n, kCluster) <= kSharedLimit ? " \
        "kCluster : elem_bytes * shared_values(n, 2 * kCluster) <= " \
        "kSharedLimit ? 2 * kCluster : 4 * kCluster;" in " ".join(src.split())
    for elem in (4, 8):
        for n in (*range(1, 481), consts["kMaxN"]):
            cluster = next((c for c in (c4, 2 * c4)
                            if elem * f["shared_values"](n, c) <= limit),
                           4 * c4)
            size = elem * f["shared_values"](n, cluster)
            assert ldl_mod.cluster_size(n, elem) == cluster
            assert size == ldl_mod.shared_bytes(n, elem) <= limit, (n, elem)
            assert f["rows_a_cta"](n, cluster) == ldl_mod.rows_a_cta(
                n, cluster)
        assert ldl_mod.cluster_size(480, elem) == (4 if elem == 4 else 16)
    consts, f, src = source_constants(sk_mod.SOURCE)
    assert "while (s > 0 && elem_bytes * shared_values(nq, nu, ns, s) > " \
        "kSharedLimit) --s;" in src
    for elem in (4, 8):
        for model in MODELS.values():
            for h in HORIZONS:
                nq, nu, ns = model.nq, model.nu, h - 1
                chunk = sk_mod.chunk_stages(nq, nu, h, elem)
                size = elem * f["shared_values"](nq, nu, ns, chunk)
                assert 1 <= chunk <= ns
                assert size == sk_mod.shared_bytes(nq, nu, h, elem) <= limit
                assert chunk == ns or elem * f["shared_values"](
                    nq, nu, ns, chunk + 1) > limit
        assert sk_mod.chunk_stages(11, 8, 10, elem) == 9


# ---- (c) the kernels' schedules against JAX ------------------------------------

def ldl_schedule(a, b, cluster, panel=32):
    """``csrc/ldl.cu``'s schedule: panels of ``panel`` columns; the diagonal
    block a column at a time (scale the column by its floored pivot, update
    the block's later columns) with its rows' forward substitution; every
    row below it eliminated on its own, the panel's column steps from the
    block's c_jk and d with its right-hand side (the rows side by side, the
    same operations a row); the trailing lower triangle takes the panel's
    updates in the order of k. Then y / d and Lᵀ x = y a block of ``panel``
    rows at a time from the last: the partial sums of ``cluster`` row owners
    (row i's by i mod cluster) gathered in the owners' order, the block
    solved a column at a time, each owner's sums taking its rows of the
    block. Returns (x, L, d)."""
    n = a.shape[-1]
    boost = torch.finfo(a.dtype).tiny
    w, r = a.clone(), b.clone()
    d = torch.empty(a.shape[:-1], dtype=a.dtype)
    for p0 in range(0, n, panel):
        q0 = min(p0 + panel, n)
        for kk in range(p0, q0):
            piv = _boost_pivot(w[:, kk, kk], boost)
            d[:, kk] = piv
            w[:, kk + 1:q0, kk] = w[:, kk + 1:q0, kk] / piv[:, None]
            w[:, kk + 1:q0, kk + 1:q0] -= ((piv[:, None] * w[:, kk + 1:q0, kk])
                                           [:, :, None]
                                           * w[:, kk + 1:q0, kk][:, None, :])
            r[:, kk + 1:q0] -= w[:, kk + 1:q0, kk] * r[:, kk:kk + 1]
        for kk in range(p0, q0):
            w[:, q0:, kk] = w[:, q0:, kk] / d[:, kk, None]
            w[:, q0:, kk + 1:q0] -= ((d[:, kk, None] * w[:, q0:, kk])[:, :, None]
                                     * w[:, kk + 1:q0, kk][:, None, :])
            r[:, q0:] -= w[:, q0:, kk] * r[:, kk:kk + 1]
        for kk in range(p0, q0):
            w[:, q0:, q0:] -= ((d[:, kk, None] * w[:, q0:, kk])[:, :, None]
                               * w[:, q0:, kk][:, None, :])
    low = torch.tril(w, -1) + torch.eye(n, dtype=a.dtype)
    z = r / _boost_pivot(d, boost)
    owner = torch.arange(n) % cluster
    acc = [torch.where(owner == q, z, torch.zeros_like(z)) for q in range(cluster)]
    x = torch.empty_like(z)
    for p0 in reversed(range(0, n, panel)):
        p1 = min(p0 + panel, n)
        v = torch.zeros_like(z[:, p0:p1])
        for q in range(cluster):
            v = v + acc[q][:, p0:p1]
        for k in range(p1 - p0 - 1, -1, -1):
            v[:, :k] -= low[:, p0 + k, p0:p0 + k] * v[:, k:k + 1]
        x[:, p0:p1] = v
        for q in range(cluster):
            for i in range(p0 + (q - p0) % cluster, p1, cluster):
                acc[q][:, :p0] -= low[:, i, :p0] * x[:, i:i + 1]
    return x, low, d


@pytest.mark.parametrize("n, m", [(100, 40), (480, 180)])
def test_ldl_schedule_matches_jax(n, m):
    rng = np.random.default_rng(n)
    a, b = sqd(rng, 2, n, m), rng.standard_normal((2, n))
    x, low, d = ldl_schedule(torch.as_tensor(a), torch.as_tensor(b),
                             ldl_mod.cluster_size(n, 8))
    l_plain, d_plain = ldl_factor(torch.as_tensor(a))
    assert torch.equal(low, l_plain) and torch.equal(d, d_plain)
    want = np.stack([np.asarray(jl.ldl_solve(jnp.asarray(a[i]),
                                             jnp.asarray(b[i])))
                     for i in range(2)])
    scale = np.abs(want).max()
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-10 * scale)


def structure_schedule(obj, aa, ab, ba, ru, rqa, rqb, rd1, rd2, beta, h):
    """``csrc/structure_kkt.cu``'s schedule. The prologue, over every stage
    at once: W = [aa ab] Q, V = ba R⁻¹, Yij, Yii's lower triangle without
    the stage before's term, and β. The chain, a stage at a time: M = Yii
    less Pᵀ P (P the stage before's Lⱼᵢ) and y's right-hand side β − Pᵀ
    y_prev; the Cholesky a column step at a time by the pivot's reciprocal
    square root, NaN in the lower triangle where a pivot is not > 0; Lⱼᵢ =
    L⁻¹ Yij and y = L⁻¹ (β − Pᵀ y_prev) a column at a time. Then the
    backward substitution and the recovery. Returns the five padded steps
    and (Lᵢᵢ, Lⱼᵢ)."""
    batch, nq, nu = aa.shape[0], aa.shape[-1], ba.shape[-1]
    n, ns = 2 * nq, h - 1
    eye = torch.eye(nq, dtype=aa.dtype)
    mv = lambda m, v: (m @ v[..., None])[..., 0]
    yiis, yijs, betas = [], [], []
    for st in range(ns):                      # the prologue
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
            yijs.append(torch.cat([
                torch.cat([(-qvn).expand(batch, nq, nq),
                           -(qan @ an.mT + qvn @ bn.mT)], -1),
                torch.cat([(-qbn).expand(batch, nq, nq),
                           -(qvn @ an.mT + qbn @ bn.mT)], -1)], -2))
        g = mv(ra, ru[:, t])
        pa, pb, pc, pd = mv(qac, rqap), mv(qbc, rqbp), mv(qvc, rqbp), \
            mv(qvc, rqap)
        yiia = (qan + mask * qbc + beta * eye).expand(batch, nq, nq)
        yiic = qvn + mask * w[..., nq:]
        yiid = (qbn + v @ bam.mT + mask * (w[..., :nq] @ a.mT
                                          + w[..., nq:] @ b_.mT)
                + beta * eye)
        yiis.append(torch.tril(torch.cat([torch.cat([yiia, yiic.mT], -1),
                                          torch.cat([yiic, yiid], -1)], -2)))
        beta1 = -rd1[:, t] + mv(qan, rqa[:, t]) + mv(qvn, rqb[:, t]) \
            - mask * (pb + pd)
        beta2 = (-rd2[:, t] - mv(bam, g) + mv(qbn, rqb[:, t])
                 + mv(qvn, rqa[:, t])
                 - mask * (mv(a, pa) + mv(b_, pb) + mv(a, pc) + mv(b_, pd)))
        betas.append(torch.cat([beta1, beta2], -1))
    lii, lji, ys = [], [], []
    for st in range(ns):                      # the chain
        m, rhs = yiis[st], betas[st]
        if st > 0:
            prev = lji[-1]
            m = m - torch.tril(prev.mT @ prev)
            rhs = rhs - mv(prev.mT, ys[-1])
        low = torch.zeros_like(m)
        rdg = torch.zeros_like(rhs)
        bad = torch.zeros(batch, dtype=torch.bool)
        for k in range(n):
            dk = m[:, k, k]
            bad |= ~(dk > 0)
            rdg[:, k] = torch.rsqrt(dk)
            low[:, k, k] = torch.sqrt(dk)
            c = m[:, k + 1:, k] * rdg[:, k, None]
            low[:, k + 1:, k] = c
            m[:, k + 1:, k + 1:] -= c[:, :, None] * c[:, None, :]
        low = torch.where(bad[:, None, None],
                          torch.full_like(low, float("nan")).tril(), low)
        rdg = torch.where(bad[:, None], float("nan"), rdg)
        cols = torch.cat([yijs[st], rhs[:, :, None]], -1) if st < ns - 1 \
            else rhs[:, :, None].clone()
        for k in range(n):                    # Lⱼᵢ's and y's columns
            cols[:, k] = cols[:, k] * rdg[:, k, None]
            cols[:, k + 1:] -= low[:, k + 1:, k, None] * cols[:, k:k + 1]
        lii.append(low)
        if st < ns - 1:
            lji.append(cols[..., :-1])
        ys.append(cols[..., -1])
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
