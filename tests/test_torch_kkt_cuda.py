"""The Newton's two KKT kernels against their plain versions on the card.

``csrc/structure_kkt.cu`` (``ops/structure_kkt.py``) and ``csrc/ldl.cu``
(``ops/ldl.py``), on the chip paths' own KKTs: the first structured KKT
that path A (the hot path, structure mode) and the structure-mode 2D
hopper (tests/test_torch_contracts_cuda.py's ``"structure"``) solve, and
the first LDLᵀ of paths B, C, D, E and F (chip_smoke.py's rollouts), each
recorded where the Newton solve calls the wrapper (the graphs' warm-up,
outside a capture) and the run stopped there:

- float64 (the recorded float32 KKT cast up): the kernel's steps agree with
  the plain version's to 1e-9 of their largest entry;
- float32: the kernel's relative residual no worse than twice the plain
  version's (the LDLᵀ: ‖A x − b‖ / ‖b‖; the structured solve: the reduced
  system's, ‖Y Δν − β‖ / ‖β‖, with Y and β in float64 from the same
  inputs);
- the LDLᵀ's factor (L and d, from the kernel's scratch) equal to the
  plain ``ldl_factor``'s bit for bit, in float32 and float64: the kernel
  keeps the plain version's operations and their order. This holds the
  float32 kernel where the residual cannot: path E's float32 KKT is solved
  to no accuracy by either version (its relative residual is above 1 for
  both), so there any x near 0 would meet the residual criterion;
- a stage block that is not positive definite gives a factor that is NaN
  in its lower triangle (zero above it) where the plain sweep's is, and a
  non-finite step; a NaN Jacobian in one lane leaves the others finite;
- path A's and C's Newton replays equal eager bit for bit, with the KKT
  kernels' launches through replays equal to eager's;
- the structured solve's chunked prologue (the centroidal family's nq 18,
  nu 12 at H = 20: every stage fits in neither type, chunks of
  ``chunk_stages``), on seeded stage inputs: float64 within 1e-9 of the
  plain version's largest entry, float32 residual no worse than twice the
  plain version's; no chip path runs it.

The tests are marked ``cuda`` and skip where CUDA is absent. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_kkt_cuda.py
"""

import os
import sys
from unittest import mock

import pytest
import torch

from contactimplicitmpc_tpu_torch.control import newton
from contactimplicitmpc_tpu_torch.control import structure_solver as ss
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.ops.ldl import ldl, ldl_factors
from contactimplicitmpc_tpu_torch.ops.linsolve import ldl_factor, ldl_solve
from contactimplicitmpc_tpu_torch.ops.structure_kkt import (
    structure_kkt, structure_kkt_factors)

TESTS = os.path.dirname(os.path.abspath(__file__))

F64_REL = 1e-9
F32_RESIDUAL_RATIO = 2.0


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


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


class _Kept(Exception):
    """Stops a run at the call it was recorded for."""


def first_call(module, name, run):
    """The arguments of the first call of ``module.name`` that ``run()``
    makes, tensors cloned; the run stops there."""
    kept = []

    def keep(*args):
        kept.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args))
        raise _Kept

    with mock.patch.object(module, name, keep):
        try:
            run()
        except _Kept:
            pass
    return kept[0]


def quadruped_run(cfg, dev):
    roll, ref, model, _, _ = make_quadruped_rollout(cfg, cfg.n_sample,
                                                    torch.float32, device=dev)
    q1s, v1s = conf_initial_states(model, ref)
    return lambda: roll(q1s, v1s)


def structure_hopper_run(dev):
    sys.path.insert(0, TESTS)
    import test_torch_contracts_cuda as contracts
    return lambda: contracts.CONTRACTS["structure"](dev)


def chip_smoke_run(rollout, steps):
    """A run of ``steps`` sim steps of chip_smoke.py's ``rollout``
    (``hopper_rollout``, ``centroidal_rollout``, ...) on the card."""
    def run(dev):
        root = os.path.dirname(TESTS)
        if root not in sys.path:
            sys.path.insert(0, root)
        import chip_smoke
        roll = getattr(chip_smoke, rollout)(dev)[0]
        return lambda: roll(steps)
    return run


STRUCTURE_RUNS = {
    "A": lambda dev: quadruped_run(HotPathConfig(), dev),
    "hopper_structure": structure_hopper_run}
LDL_RUNS = {
    "B": chip_smoke_run("hopper_rollout", 5),
    "C": lambda dev: quadruped_run(HotPathConfig(newton_mode="direct"), dev),
    "D": chip_smoke_run("centroidal_rollout", 5),
    "E": chip_smoke_run("flamingo_rollout", 5),
    "F": chip_smoke_run("hopper3d_rollout", 10)}


def structure_case(path, dev):
    """(dims, objective, Jacobians and residuals, β, H) of the first
    structured KKT of ``path``'s run."""
    args = first_call(ss, "structure_kkt", STRUCTURE_RUNS[path](dev))
    return args[0], args[1], list(args[2:10]), args[10], args[11]


def ldl_case(path, dev):
    """(A, b) of the first LDLᵀ of ``path``'s run."""
    return first_call(newton, "ldl", LDL_RUNS[path](dev))


def cast(obj, xs, dtype):
    return (type(obj)(*(x.to(dtype) for x in obj)),
            [x.to(dtype) for x in xs])


def rel(got, want):
    """Largest |got − want| over the largest |want|, over every output."""
    return max(float((g.double() - w.double()).abs().max()
                     / w.double().abs().max()) for g, w in zip(got, want))


def reduced_residual(dims, obj, xs, beta, h, steps):
    """‖Y Δν − β‖ / ‖β‖ over the batch, Y and β in float64 from the inputs
    ``xs`` and Δν = (Δν1, Δν2) of ``steps``."""
    obj64, xs64 = cast(obj, xs, torch.float64)
    yii, yij = ss.compute_y_blocks(obj64, *xs64[:3], beta, h)
    rhs = ss.structure_beta(obj64, *xs64, h)
    x = torch.cat([steps[3][..., 1:, :], steps[4][..., 1:, :]], -1).double()
    mv = lambda m, v: (m @ v[..., None])[..., 0]
    res = mv(yii, x)
    res[..., :-1, :] += mv(yij, x[..., 1:, :])
    res[..., 1:, :] += mv(yij.mT, x[..., :-1, :])
    return float(torch.linalg.norm(res - rhs) / torch.linalg.norm(rhs))


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(STRUCTURE_RUNS))
def test_structure_kernel_matches_plain(card, path):
    dims, obj, xs, beta, h = structure_case(path, card)
    obj64, xs64 = cast(obj, xs, torch.float64)
    got = structure_kkt(dims, obj64, *xs64, beta, h)
    want = ss.structure_kkt_solve(dims, obj64, *xs64, beta, h)
    err = rel(got, want)
    got32 = structure_kkt(dims, obj, *xs, beta, h)
    want32 = ss.structure_kkt_solve(dims, obj, *xs, beta, h)
    res = [reduced_residual(dims, obj, xs, beta, h, s)
           for s in (got32, want32)]
    print(f"path {path}: {tuple(xs[0].shape)}, float64 rel {err:.3g}; "
          f"float32 residual kernel {res[0]:.3g}, plain {res[1]:.3g}")
    assert err <= F64_REL, err
    assert res[0] <= F32_RESIDUAL_RATIO * res[1], res
    assert all(bool(torch.isfinite(s).all()) for s in got + got32)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(LDL_RUNS))
def test_ldl_kernel_matches_plain(card, path):
    a, b = ldl_case(path, card)
    a64, b64 = a.double(), b.double()
    err = rel([ldl(a64, b64)], [ldl_solve(a64, b64)])

    def residual(x):
        r = (a64 @ x.double()[..., None])[..., 0] - b64
        return float(torch.linalg.norm(r) / torch.linalg.norm(b64))

    res = [residual(ldl(a, b)), residual(ldl_solve(a, b))]
    print(f"path {path}: n = {a.shape[-1]}, {a.shape[0]} lanes, float64 rel "
          f"{err:.3g}; float32 residual kernel {res[0]:.3g}, plain "
          f"{res[1]:.3g}")
    assert err <= F64_REL, err
    assert res[0] <= F32_RESIDUAL_RATIO * res[1], res
    assert factors_equal(a, b) and factors_equal(a64, b64)


def factors_equal(a, b):
    """Whether the kernel's L and d equal the plain ``ldl_factor``'s bit
    for bit."""
    _, l, d = ldl_factors(a, b)
    want_l, want_d = ldl_factor(a)
    return torch.equal(l, want_l) and torch.equal(d, want_d)


@pytest.mark.cuda
def test_chunked_structure_kernel_matches_plain(card):
    import numpy as np
    from contactimplicitmpc_tpu_torch.dims import Dims
    from contactimplicitmpc_tpu_torch.ops import structure_kkt as sk_mod
    nq, nu, h = 18, 12, 20
    rng = np.random.default_rng(18)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=card)
    dims = Dims(nq=nq, nu=nu, nw=0, nc=1, nf=2, ne=2)
    obj = ss.build_structure_objective(
        dims, t(0.5 + rng.random((h + 1, nq))),
        t(0.1 + 0.1 * rng.random((h + 1, nq))),
        t(0.5 + rng.random((h + 1, nu))), 1e-6, h)
    shapes = [(h, nq, nq), (h, nq, nq), (h, nq, nu), (h, nu), (h, nq),
              (h, nq), (h, nq), (h, nq)]
    xs = [t(rng.standard_normal((4,) + s) * (0.3 if len(s) == 3 else 1.0))
          for s in shapes]
    chunks = [sk_mod.chunk_stages(nq, nu, h, e) for e in (4, 8)]
    assert max(chunks) < h - 1, chunks
    err = rel(structure_kkt(dims, obj, *xs, 1e-5, h),
              ss.structure_kkt_solve(dims, obj, *xs, 1e-5, h))
    obj32, xs32 = cast(obj, xs, torch.float32)
    res = [reduced_residual(dims, obj32, xs32, 1e-5, h,
                            fn(dims, obj32, *xs32, 1e-5, h))
           for fn in (structure_kkt, ss.structure_kkt_solve)]
    print(f"chunks {chunks}: float64 rel {err:.3g}; float32 residual kernel "
          f"{res[0]:.3g}, plain {res[1]:.3g}")
    assert err <= F64_REL, err
    assert res[0] <= F32_RESIDUAL_RATIO * res[1], res


@pytest.mark.cuda
def test_non_pd_stage_block_gives_a_nan_factor(card):
    dims, obj, xs, _, h = structure_case("A", card)
    obj64, xs64 = cast(obj, xs, torch.float64)
    beta = -1e3      # the first diagonal block is not positive definite
    steps, lii, lji = structure_kkt_factors(dims, obj64, *xs64, beta, h)
    yii, yij = ss.compute_y_blocks(obj64, *xs64[:3], beta, h)
    want_l, _ = ss.block_tridiag_cholesky(yii, yij)
    assert torch.equal(torch.isnan(lii), torch.isnan(want_l))
    upper = torch.triu(torch.ones_like(lii[0, 0], dtype=torch.bool), 1)
    assert bool((lii[..., upper] == 0).all())
    assert bool(torch.isnan(lii[:, 0].diagonal(dim1=-2, dim2=-1)).all())
    assert not any(bool(torch.isfinite(s[:, 1:]).all()) for s in steps)
    # a NaN Jacobian in lane 1 alone
    xs64[0] = xs64[0].clone()
    xs64[0][1, 3, 0, 0] = float("nan")
    steps = structure_kkt(dims, obj64, *xs64, 1e-5, h)
    finite = torch.stack([torch.isfinite(s).flatten(1).all(1)
                          for s in steps]).all(0)
    assert not bool(finite[1]) and bool(finite[0]) and bool(finite[2:].all())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["A", "C"])
def test_newton_replays_launch_the_kkt_kernel_as_eager_does(card, path):
    sys.path.insert(0, TESTS)
    import test_torch_newton_graphs_cuda as newton_tests
    solve, args = newton_tests.path_call(path, card)
    counter = structure_kkt if solve.structure else ldl
    got = solve(*args)                              # captures
    counts = []
    for fn in (lambda: solve(*args), lambda: solve._eager(*args)):
        torch.cuda.synchronize()
        counter.launches = 0
        fn()
        torch.cuda.synchronize()
        counts.append(counter.launches)
    want = solve._eager(*args)
    torch.cuda.synchronize()
    print(f"path {path}: {counter.__name__} launches replayed / eager "
          f"{counts}")
    assert all(newton_tests.equal(got, want))
    assert counts[0] == counts[1] > 0, counts
