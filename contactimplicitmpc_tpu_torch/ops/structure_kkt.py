"""The structure-mode Newton's KKT solve in one launch: wrapper of the Hopper
kernel ``csrc/structure_kkt.cu``.

``structure_kkt(dims, obj, aa, ab, ba, rlagu, rlagqa, rlagqb, rdyn1, rdyn2,
β, H)`` is ``control/structure_solver.py::structure_kkt_solve`` with the same
arguments and results: the β right-hand side, the Y = C S⁻¹ Cᵀ blocks, the
block Cholesky sweep, both substitutions and the step's recovery, the five
padded steps (Δu, Δqa, Δqb, Δν1, Δν2) out. Any leading batch of the
Jacobians and residuals is flattened into the kernel's problems, a block
each; the objective ``obj`` (a ``StructureObjective``, (H+1, ·, ·) leaves) is
shared by all of them.

The route is a pure function of the tensors' device, type and (nq, nu, H)
(``route``): CPU tensors take the plain version, ``structure_kkt_solve``,
which ``control/structure_solver.py`` owns and calls itself (the wrapper
raises on them); float32 and float64 CUDA tensors of dimensions the source
holds (2 nq ≤ ``MAX_N``, nu ≤ ``MAX_NU``, H ≥ ``MIN_H`` and at least one
stage a chunk within an H100 block's 227 KB of shared memory: every model
of the JAX package at the horizons its examples run) launch the kernel;
anything else on the card raises. There is no fallback. The kernel takes
its stages in chunks of ``chunk_stages`` (the source's rule: every stage
where they fit, as at path A's shape in both types, else the most that
fit), a prologue a chunk.

``control/structure_solver.py::structure_newton_solve`` calls it on CUDA
tensors once a masked Newton trip, inside the solve's CUDA graph
(``control/graphs.py``): it launches on the current stream and allocates
its outputs and the factors' scratch with ``torch.empty``, which a capture
takes from the graph's pool. ``structure_kkt.launches`` counts the launches
where they are made. ``structure_kkt_factors`` also returns the scratch,
the block Cholesky factors (Lᵢᵢ (…, H−1, 2nq, 2nq), Lⱼᵢ (…, H−2, 2nq,
2nq)) that ``block_tridiag_cholesky`` gives.

``work`` counts the operations and bytes of a call, and ``bound_ms`` turns
them into the kernel's bound on an H100. The kernel is compiled from the
repository's source with ``nvcc`` at first use into ``build/``
(``cuda_build.py``) and loaded with ``ctypes``; ``phase_clocks`` runs a
build of it that clocks its phases (``-DKKT_PHASE_CLOCKS``).
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from ..dims import Dims
from . import cuda_build
from .cuda_build import CSRC

SOURCE = os.path.join(CSRC, "structure_kkt.cu")
CLOCKS_HEADER = os.path.join(CSRC, "kkt_clocks.cuh")
# the source's kThreads, kMaxN (2 nq), kMaxNu and kMinH, and an H100 block's
# shared bytes
THREADS, MAX_N, MAX_NU, MIN_H = 256, 64, 64, 3
SHARED_LIMIT = 227 * 1024
DTYPES = (torch.float32, torch.float64)

_LIBS = {}   # phase_clocks: the loaded library


def build(verbose: bool = False, phase_clocks: bool = False) -> str:
    """Compile ``csrc/structure_kkt.cu`` into ``build/``
    (``cuda_build.build``), with ``phase_clocks`` the build whose block 0
    clocks its phases (``-DKKT_PHASE_CLOCKS``); returns the library's
    path."""
    return cuda_build.build(SOURCE, verbose, deps=(CLOCKS_HEADER,),
                            defines=("-DKKT_PHASE_CLOCKS",) if phase_clocks
                            else ())


def _padded(count: int) -> int:
    return (count + 7) // 4 * 4


def shared_values(nq: int, nu: int, ns: int, s: int) -> int:
    """A block's values for ns = H − 1 stages in chunks of s (the source's
    ``shared_values``): a chunk's inputs, each in a room of whole 16-byte
    runs with the source's alignment (aa, ab, qat, qbt, qvt over s + 1
    knots, rat, ba, ru, rdyn1, rdyn2 over s, rlagqa, rlagqb over s + 1); a
    chunk stage's Yii then L and Yij then Lji (rows of 2nq + 1), W, V and
    β's products; the Cholesky's columns (32 × 32), every stage's y,
    x and pivot reciprocals, the chunk
    before's last Lⱼᵢ, the recovery's eₐ, e_b and Δu's inner vector, and
    two ints (the Cholesky's progress, a stage's non-positive pivot)."""
    q2 = nq * nq
    inputs = (5 * _padded((s + 1) * q2) + _padded(s * nu * nu)
              + _padded(s * nq * nu) + _padded(s * nu) + 2 * _padded(s * nq)
              + 2 * _padded((s + 1) * nq))
    stage = 4 * nq * (2 * nq + 1) + 2 * q2 + nq * nu + nu + 4 * nq
    fixed = (32 * 32 + 6 * ns * nq + 2 * nq * (2 * nq + 1) + ns * (2 * nq + nu)
             + 2)
    return inputs + s * stage + fixed


def chunk_stages(nq: int, nu: int, h: int, elem_bytes: int) -> int:
    """The source's rule (``chunk_stages``): a chunk takes every one of the
    H − 1 stages where they fit a block's shared memory, else the most that
    fit; 0 where one does not."""
    ns = h - 1
    s = ns
    while s > 0 and elem_bytes * shared_values(nq, nu, ns, s) > SHARED_LIMIT:
        s -= 1
    return s


def shared_bytes(nq: int, nu: int, h: int, elem_bytes: int) -> int:
    """A block's shared bytes, in chunks of ``chunk_stages``."""
    return elem_bytes * shared_values(nq, nu, h - 1,
                                      chunk_stages(nq, nu, h, elem_bytes))


def _load(phase_clocks: bool = False):
    if phase_clocks not in _LIBS:
        lib = ctypes.CDLL(build(phase_clocks=phase_clocks))
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.structure_kkt_shared_bytes.restype = i32
        lib.structure_kkt_shared_bytes.argtypes = [i32] * 4
        lib.structure_kkt_chunk_stages.restype = i32
        lib.structure_kkt_chunk_stages.argtypes = [i32] * 4
        lib.structure_kkt_launch.restype = i32
        lib.structure_kkt_launch.argtypes = [i32, ptr, ptr] + [i32] * 4 + [
            f64, ptr]
        for nq, nu, h in ((11, 8, 10), (18, 12, 20), (2, 1, 3)):
            for elem in (4, 8):
                got = (lib.structure_kkt_chunk_stages(elem, nq, nu, h),
                       lib.structure_kkt_shared_bytes(elem, nq, nu, h))
                want = (chunk_stages(nq, nu, h, elem),
                        shared_bytes(nq, nu, h, elem))
                if got != want:
                    raise RuntimeError(
                        f"structure_kkt: the kernel takes chunks of {got[0]} "
                        f"stages and {got[1]} shared bytes at (nq, nu, H) = "
                        f"{(nq, nu, h)}, the wrapper {want}")
        if phase_clocks:
            cuda_build.bind_clocks(lib)
        _LIBS[phase_clocks] = lib
    return _LIBS[phase_clocks]


def route(device, dtype, nq: int, nu: int, h: int) -> str:
    """``"plain"`` for CPU tensors, ``"cuda"`` for float32 or float64 CUDA
    tensors of dimensions the source holds; raises otherwise."""
    if torch.device(device).type == "cpu":
        return "plain"
    if dtype not in DTYPES:
        raise ValueError(f"structure_kkt: the kernel takes float32 or "
                         f"float64, got {dtype}")
    elem = torch.empty((), dtype=dtype).element_size()
    if not (1 <= nq and 2 * nq <= MAX_N and 1 <= nu <= MAX_NU and h >= MIN_H
            and chunk_stages(nq, nu, h, elem) >= 1):
        raise ValueError(f"structure_kkt: (nq, nu, H) = {(nq, nu, h)} is "
                         f"outside what the kernel holds (2 nq ≤ {MAX_N}, "
                         f"nu ≤ {MAX_NU}, H ≥ {MIN_H}, {SHARED_LIMIT} shared "
                         f"bytes a block)")
    return "cuda"


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch(dims: Dims, obj, aa, ab, ba, rlagu, rlagqa, rlagqb, rdyn1,
            rdyn2, beta, h, lib=None):
    if route(aa.device, aa.dtype, dims.nq, dims.nu, h) != "cuda":
        raise ValueError("structure_kkt: the kernel runs on CUDA tensors; "
                         "CPU tensors take structure_kkt_solve")
    nq, nu = dims.nq, dims.nu
    lead = aa.shape[:-3]
    expect = {"aa": (aa, (h, nq, nq)), "ab": (ab, (h, nq, nq)),
              "ba": (ba, (h, nq, nu)), "rlagu": (rlagu, (h, nu)),
              "rlagqa": (rlagqa, (h, nq)), "rlagqb": (rlagqb, (h, nq)),
              "rdyn1": (rdyn1, (h, nq)), "rdyn2": (rdyn2, (h, nq))}
    shared = {"qat": (obj.qat, (h + 1, nq, nq)),
              "qbt": (obj.qbt, (h + 1, nq, nq)),
              "qvt": (obj.qvt, (h + 1, nq, nq)),
              "rat": (obj.rat, (h + 1, nu, nu))}
    for name, (t, tail) in {**expect, **shared}.items():
        shape = tail if name in shared else tuple(lead) + tail
        if tuple(t.shape) != shape:
            raise ValueError(f"structure_kkt: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != aa.dtype or t.device != aa.device:
            raise ValueError(f"structure_kkt: {name} must be {aa.dtype} on "
                             f"{aa.device}, got {t.dtype} on {t.device}")
    batch = math.prod(lead)
    flat = [t.reshape((batch,) + tail).contiguous()
            for t, tail in expect.values()]
    objs = [t.contiguous() for t, _ in shared.values()]
    n, ns = 2 * nq, h - 1
    new = lambda *shape: torch.empty((batch,) + shape, dtype=aa.dtype,
                                     device=aa.device)
    steps = [new(h, nu)] + [new(h, nq) for _ in range(4)]
    lii, lji = new(ns, n, n), new(ns - 1, n, n)
    ins = objs + flat
    outs = steps + [lii, lji]
    lib = lib or _load()
    with torch.cuda.device(aa.device):
        stream = torch.cuda.current_stream(aa.device).cuda_stream
        err = lib.structure_kkt_launch(
            aa.element_size(), _ptrs(ins), _ptrs(outs), batch, nq, nu, h,
            float(beta), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"structure_kkt launch failed: error {err}"
                           + (" (unsupported dimensions or type)" if err == -1
                              else ""))
    structure_kkt.launches += 1
    unflat = lambda t: t.reshape(tuple(lead) + t.shape[1:])
    return tuple(map(unflat, steps)), unflat(lii), unflat(lji)


def structure_kkt(dims: Dims, obj, aa, ab, ba, rlagu, rlagqa, rlagqb, rdyn1,
                  rdyn2, beta, horizon):
    """``structure_kkt_solve``'s five padded steps by one launch of the
    kernel, on CUDA tensors (``route``); raises on CPU tensors."""
    return _launch(dims, obj, aa, ab, ba, rlagu, rlagqa, rlagqb, rdyn1,
                   rdyn2, beta, horizon)[0]


structure_kkt.launches = 0  # kernel launches, counted where the kernel launches


def structure_kkt_factors(dims: Dims, obj, aa, ab, ba, rlagu, rlagqa, rlagqb,
                          rdyn1, rdyn2, beta, horizon):
    """One launch on CUDA tensors: (the five steps, Lᵢᵢ, Lⱼᵢ), the block
    Cholesky factors from the kernel's scratch (a block that is not positive
    definite: NaN in its lower triangle)."""
    return _launch(dims, obj, aa, ab, ba, rlagu, rlagqa, rlagqb, rdyn1,
                   rdyn2, beta, horizon)


# the clocked build's phases, in the source's order
# (``csrc/structure_kkt.cu::Phase``): a chunk's inputs and prologue, then a
# stage's chain (summed over the stages), the chunks' last factors out, the
# backward substitution and the recovery
PHASES = ("inputs", "prologue", "m", "cholesky", "lji_and_forward",
          "factor_out", "backward", "recovery")


def phase_clocks(dims: Dims, obj, aa, ab, ba, rlagu, rlagqa, rlagqb, rdyn1,
                 rdyn2, beta, horizon) -> dict:
    """One launch of the clocked build (``-DKKT_PHASE_CLOCKS``) on CUDA
    tensors: the SM clock cycles thread 0 of problem 0 spent in each of
    ``PHASES``."""
    lib = _load(phase_clocks=True)
    return cuda_build.clocked(lib, PHASES, aa.device, lambda: _launch(
        dims, obj, aa, ab, ba, rlagu, rlagqa, rlagqb, rdyn1, rdyn2, beta,
        horizon, lib))


# ---- the bound ---------------------------------------------------------------

def work(nq: int, nu: int, h: int, batch: int, elem_bytes: int) -> tuple:
    """(floating-point operations, bytes) of one call on ``batch``
    problems, a multiply-add counted as two, the least the solve needs.
    Every stage (n = 2 nq): V = ba R⁻¹ (2 nq nu²), ba R⁻¹ baᵀ over the
    lower triangle of Yii's lower-right block (nq(nq+1)/2 · 2 nu), the
    Cholesky (n − k − 1 scalings and (n − k − 1)(n − k)/2 multiply-adds a
    column), β's terms without the stage before (2 nu² + 2 nq nu + 8 nq²),
    the two triangular solves of the substitutions (2 n²) and the step's
    recovery but its look-ahead (2 nq nu + 2 nu² + 8 nq²). The ns − 1
    stages that have a stage before or after also: W = [aa ab] Q (8 nq³)
    and W Gᵀ over that triangle (nq(nq+1)/2 · 4 nq), the off-diagonal block
    (8 nq³), M = Yii − PᵀP over its lower triangle (n(n+1)/2 · 2n), Lⱼᵢ =
    L⁻¹ Yij (n³), β's terms from the stage before (16 nq²), the
    substitutions' products by Lⱼᵢ (4 n²) and the recovery's look-ahead
    (4 nq²). Bytes are every input and every output once; the factors'
    scratch is the kernel's own."""
    n, ns = 2 * nq, h - 1
    tri = lambda m: m * (m + 1) // 2
    cholesky = sum((n - k - 1) + (n - k - 1) * (n - k) for k in range(n))
    every = (2 * nq * nu * nu + tri(nq) * 2 * nu + cholesky
             + 2 * nu * nu + 2 * nq * nu + 8 * nq * nq
             + 2 * n * n + 2 * nq * nu + 2 * nu * nu + 8 * nq * nq)
    linked = (8 * nq ** 3 + tri(nq) * 4 * nq + 8 * nq ** 3 + tri(n) * 2 * n
              + n ** 3 + 16 * nq * nq + 4 * n * n + 4 * nq * nq)
    flops = batch * (ns * every + (ns - 1) * linked)
    objective = (h + 1) * (3 * nq * nq + nu * nu)
    inputs = batch * h * (2 * nq * nq + nq * nu + nu + 4 * nq)
    outputs = batch * h * (nu + 4 * nq)
    return flops, elem_bytes * (objective + inputs + outputs)


# NVIDIA H100 SXM, published peaks: outside the tensor cores by the values'
# bytes (float32, float64), and HBM3
PEAK_FLOPS = {4: 67e12, 8: 34e12}
PEAK_BYTES = 3.35e12


def bound_ms(nq: int, nu: int, h: int, batch: int, elem_bytes: int):
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    one call, the larger of ``work``'s operations over the card's rate for
    the type and its bytes over the card's memory rate, and which."""
    flops, nbytes = work(nq, nu, h, batch, elem_bytes)
    by = {"operations": 1e3 * flops / PEAK_FLOPS[elem_bytes],
          "bytes": 1e3 * nbytes / PEAK_BYTES}
    which = max(by, key=by.get)
    return by[which], which
