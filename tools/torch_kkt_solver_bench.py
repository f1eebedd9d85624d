#!/usr/bin/env python
"""Microbenchmark of the direct-mode horizon-KKT solve on the PyTorch port —
the counterpart of tools/kkt_solver_bench.py.

Workload: the direct-mode Newton's linear solve (``control/newton.py``):
one symmetric quasidefinite KKT matrix a rollout lane, at the sizes the
chip paths give it, float32:

- n = 300: the quadruped in configuration mode at H = 10, 10 · (19 + 11)
  (chip_smoke.py's path C);
- n = 480: the centroidal (and point-foot) quadruped, 10 · (30 + 18)
  (paths D, I and K);

each at a batch of 16 lanes (the chip paths) and 256 (a sweep). The matrix
is synthetic with the real block signature, as the JAX tool's: an SPD
primal block, a negative-definite dual block, dense symmetrized couplings
and ±2 on the diagonal, drawn with numpy from ``default_rng(0)``. The JAX
tool's couplings, 0.1 · N(0, 1), leave some primal blocks indefinite (their
spectrum spreads ≈ 0.1 · √(2 · primal rows) about the diagonal: 1.95 at
n = 300, 2.45 at n = 480); here they are N(0, 1) / √(2 · primal rows), so
the primal block's spread stays ≈ 1, half its diagonal, at every n. Every
matrix's blocks are checked definite (``eigvalsh``) before any time.

Backends: the port's unpivoted LDLᵀ as the Newton runs it
(``ops/ldl.py::ldl``: on the card one launch of the hand-written kernel
``csrc/ldl.cu``, on the CPU its plain version) against PyTorch's pivoted LU
(``torch.linalg.solve_ex``, the ``kkt_solver="lu"`` backend); on the card
also the plain version (``ops/linsolve.py::ldl_solve``, a Python loop of n
dependent rank-1 updates) and the library's pivoted LDLᵀ
(``torch.linalg.ldl_factor_ex`` + ``torch.linalg.ldl_solve``, sytrf).
Times are CUDA events on the card around ``--reps`` calls after a warm
call (the host clock on the CPU). Each backend's solution is checked
against the LU's and by its residual, and on the synthetic matrices a
residual past ``RESIDUAL_TOL`` of the right-hand side raises before a time
is printed (a path's KKT is what the Newton met: its residuals are
reported as they are).

``--paths BCDEF`` (on the card) times the same backends on each direct chip
path's own first KKT (tests/test_torch_kkt_cuda.py's ``ldl_case``: the
first LDLᵀ of chip_smoke.py's path B, C, D, E or F, n = 100, 300, 480, 360,
340, 16 lanes) instead of the synthetic ones.

Run: python tools/torch_kkt_solver_bench.py [--n 300,480] [--batch 16,256]
     [--reps 5] [--cpu] [--paths BCDEF]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# n: (H, primal rows a knot, dual rows a knot) of the paths' KKTs
SHAPES = {300: (10, 19, 11), 480: (10, 30, 18)}
# largest residual, relative to the right-hand side's largest entry, that a
# float32 solve of these well-conditioned matrices may leave
RESIDUAL_TOL = 1e-3


def kkt_batch(n, batch, device, primal=None):
    """``batch`` synthetic SQD KKT matrices (batch, n, n) and right-hand
    sides (batch, n), float32, from ``numpy.random.default_rng(0)``; the
    first ``primal`` rows (the paths' H · nr where n is one of ``SHAPES``,
    else n // 2) are the SPD block, the rest the negative-definite one;
    raises if any matrix's blocks are not."""
    import numpy as np
    import torch

    if primal is None:
        h, nr, _ = SHAPES.get(n, (1, n // 2, 0))
        primal = h * nr
    rng = np.random.default_rng(0)
    a = rng.standard_normal((batch, n, n)) / np.sqrt(2.0 * primal)
    sym = 0.5 * (a + np.swapaxes(a, 1, 2))
    diag = np.concatenate([2.0 * np.ones(primal), -2.0 * np.ones(n - primal)])
    mats = sym + np.diag(diag)[None]
    lo = np.linalg.eigvalsh(mats[:, :primal, :primal]).min()
    hi = np.linalg.eigvalsh(mats[:, primal:, primal:]).max() \
        if primal < n else -1.0
    if not (lo > 0.0 and hi < 0.0):
        raise ValueError(f"n={n}: not quasidefinite (primal block's least "
                         f"eigenvalue {lo:.3g}, dual block's largest {hi:.3g})")
    rhs = rng.standard_normal((batch, n))
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return as_t(mats), as_t(rhs)


def time_ms(fn, reps, device):
    """Milliseconds a call of ``fn`` after one warm call: CUDA events around
    ``reps`` calls on the card, the host clock on the CPU."""
    import torch

    out = fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def backends(mats, rhs):
    """{name: solve} of the backends (the module's docstring): the LDLᵀ as
    the Newton runs it and the LU everywhere, the plain LDLᵀ and the
    library's pivoted LDLᵀ on the card."""
    import torch

    from contactimplicitmpc_tpu_torch.ops.ldl import ldl
    from contactimplicitmpc_tpu_torch.ops.linsolve import ldl_solve

    def sytrf():
        fac, piv, _ = torch.linalg.ldl_factor_ex(mats)
        return torch.linalg.ldl_solve(fac, piv, rhs[..., None])[..., 0]

    out = {"ldl": lambda: ldl(mats, rhs),
           "lu": lambda: torch.linalg.solve_ex(mats, rhs)[0]}
    if mats.is_cuda:
        out.update(plain=lambda: ldl_solve(mats, rhs), sytrf=sytrf)
    return out


def bench(n, batch, reps, device, case=None):
    """One shape: each backend's ms a batched solve and its largest
    residual relative to the right-hand side, and its solution's largest
    difference from the LU's relative to its scale (``agreement``, the
    LDLᵀ's). ``case`` is a recorded (matrices, right-hand sides) to use
    instead of the synthetic ones."""
    import torch

    mats, rhs = case if case is not None else kkt_batch(n, batch, device)
    result = {"n": n, "batch": batch}
    xs = {}
    for name, fn in backends(mats, rhs).items():
        x, ms = time_ms(fn, reps if name != "plain" else 1, device)
        res = torch.einsum("bij,bj->bi", mats, x) - rhs
        result[f"{name}_ms"] = ms
        result[f"{name}_rel_residual"] = float(res.abs().max()
                                              / rhs.abs().max())
        if case is None and not result[f"{name}_rel_residual"] < RESIDUAL_TOL:
            raise RuntimeError(
                f"n={n} batch={batch}: {name} relative residual "
                f"{result[f'{name}_rel_residual']:.2e} past {RESIDUAL_TOL}")
        xs[name] = x
    for name in xs:
        if name != "lu":
            key = "agreement" if name == "ldl" else f"{name}_agreement"
            result[key] = float((xs[name] - xs["lu"]).abs().max()
                                / xs["lu"].abs().max())
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=str, default="300,480")
    ap.add_argument("--batch", type=str, default="16,256")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--paths", type=str, default="")
    args = ap.parse_args(argv)

    import torch

    from contactimplicitmpc_tpu_torch.device import describe, resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    tag = describe(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    if args.paths and device.type != "cuda":
        raise SystemExit("torch_kkt_solver_bench: --paths runs on the card")
    cases = []
    if args.paths:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import test_torch_kkt_cuda as kkt_tests
        for path in args.paths:
            a, b = kkt_tests.ldl_case(path, device)
            cases.append((f"path {path}", a.shape[-1], a.shape[0], (a, b)))
    else:
        cases = [("synthetic", int(n), int(batch), None)
                 for n in args.n.split(",") for batch in args.batch.split(",")]
    for what, n, batch, case in cases:
        r = bench(n, batch, args.reps, device, case)
        r["kkt"] = what
        results.append(r)
        extra = "".join(
            f", {name} {r[f'{name}_ms']:.3f} ms ({r[f'{name}_rel_residual']:.2e})"
            for name in ("plain", "sytrf") if f"{name}_ms" in r)
        print(f"n={n} batch={batch}: ldl {r['ldl_ms']:.3f} ms "
              f"({batch / r['ldl_ms'] * 1e3:.0f} KKT-solves/s, max rel "
              f"residual {r['ldl_rel_residual']:.2e}), solve_ex "
              f"{r['lu_ms']:.3f} ms ({batch / r['lu_ms'] * 1e3:.0f} "
              f"KKT-solves/s, {r['lu_rel_residual']:.2e}){extra}; backends "
              f"agree to {r['agreement']:.2e} ({what}) [{tag}]", flush=True)
    print(json.dumps({"kkt_solver_bench": results, "device": tag}))
    return results


if __name__ == "__main__":
    main()
