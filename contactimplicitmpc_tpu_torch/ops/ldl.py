"""The direct-mode Newton's KKT solve in one launch: wrapper of the Hopper
kernel ``csrc/ldl.cu``.

``ldl(a, b)`` is ``ops/linsolve.py::ldl_solve(a, b)`` for a batch of
symmetric (quasi-definite) matrices ``a`` (..., n, n) and one right-hand
side each, ``b`` (..., n): the unpivoted LDLᵀ with its pivots floored at the
dtype's ``tiny`` (or at ``boost``), then the two triangular solves. The
route is a pure function of the tensors' device, type and n (``route``):
CPU tensors take the plain version, ``ldl_solve`` itself; float32 and
float64 CUDA tensors of an n the source holds (``MAX_N``, and a block's
shared memory within an H100's 227 KB) launch the kernel, a block a matrix;
anything else on the card raises. There is no fallback. The kernel's factor
is the plain version's, operation for operation (``csrc/ldl.cu``), so L and
d agree bit for bit and the solution to rounding.

The control/newton.py trip calls it for the KKT of every direct-mode Newton
iteration (``use_ldl``), inside the trip's CUDA graph: it launches on the
current stream and allocates its scratch (the working matrix, (..., n, n))
with ``torch.empty``, which a capture takes from the graph's pool.
``ldl.launches`` counts the launches where they are made. ``ldl_factors``
also returns the factor the scratch ends holding (L and d).

``work`` counts the operations and bytes of a call, and ``bound_ms`` turns
them into the kernel's bound on an H100. The kernel is compiled from the
repository's source with ``nvcc`` at first use into ``build/``
(``cuda_build.py``) and loaded with ``ctypes``; ``phase_clocks`` runs a
build of it that clocks its phases (``-DKKT_PHASE_CLOCKS``).
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_build
from .cuda_build import CSRC
from .linsolve import ldl_solve

SOURCE = os.path.join(CSRC, "ldl.cu")
CLOCKS_HEADER = os.path.join(CSRC, "kkt_clocks.cuh")
# the source's kThreads, kPanel and kMaxN, and an H100 block's shared bytes
THREADS, PANEL, MAX_N = 512, 32, 768
SHARED_LIMIT = 227 * 1024
DTYPES = (torch.float32, torch.float64)

_LIBS = {}   # phase_clocks: the loaded library


def build(verbose: bool = False, phase_clocks: bool = False) -> str:
    """Compile ``csrc/ldl.cu`` into ``build/`` (``cuda_build.build``),
    with ``phase_clocks`` the build whose block 0 clocks its phases
    (``-DKKT_PHASE_CLOCKS``); returns the library's path."""
    return cuda_build.build(SOURCE, verbose, deps=(CLOCKS_HEADER,),
                            defines=("-DKKT_PHASE_CLOCKS",) if phase_clocks
                            else ())


def shared_bytes(n: int, elem_bytes: int) -> int:
    """A block's shared bytes for an n × n matrix (the source's
    ``shared_values``): the panel's n rows of ``PANEL + 1`` values, d and
    the right-hand side."""
    return elem_bytes * (n * (PANEL + 1) + 2 * n)


def _load(phase_clocks: bool = False):
    if phase_clocks not in _LIBS:
        lib = ctypes.CDLL(build(phase_clocks=phase_clocks))
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.ldl_shared_bytes.restype = i32
        lib.ldl_shared_bytes.argtypes = [i32, i32]
        lib.ldl_launch.restype = i32
        lib.ldl_launch.argtypes = [i32] + [ptr] * 4 + [i32, i32, f64, ptr]
        for n in (1, 300, MAX_N):
            for elem in (4, 8):
                if lib.ldl_shared_bytes(elem, n) != shared_bytes(n, elem):
                    raise RuntimeError(f"ldl: the kernel takes "
                                       f"{lib.ldl_shared_bytes(elem, n)} shared "
                                       f"bytes at n = {n}, the wrapper "
                                       f"{shared_bytes(n, elem)}")
        if phase_clocks:
            cuda_build.bind_clocks(lib)
        _LIBS[phase_clocks] = lib
    return _LIBS[phase_clocks]


def route(device, dtype, n: int) -> str:
    """``"plain"`` for CPU tensors, ``"cuda"`` for float32 or float64 CUDA
    tensors of an n the source holds; raises otherwise."""
    if torch.device(device).type == "cpu":
        return "plain"
    if dtype not in DTYPES:
        raise ValueError(f"ldl: the kernel takes float32 or float64, got {dtype}")
    elem = torch.empty((), dtype=dtype).element_size()
    if not 1 <= n <= MAX_N or shared_bytes(n, elem) > SHARED_LIMIT:
        raise ValueError(f"ldl: n = {n} is outside what the kernel holds "
                         f"(1 to {MAX_N})")
    return "cuda"


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _launch(a, b, boost: float, lib=None):
    n = a.shape[-1]
    if tuple(a.shape[-2:]) != (n, n) or tuple(b.shape) != tuple(a.shape[:-1]):
        raise ValueError(f"ldl: a (..., n, n) and b (..., n) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.dtype != a.dtype or b.device != a.device:
        raise ValueError("ldl: a and b must share a type and a device")
    lead = a.shape[:-2]
    a2 = a.reshape(-1, n, n).contiguous()
    b2 = b.reshape(-1, n).contiguous()
    x = torch.empty_like(b2)
    work = torch.empty_like(a2)
    lib = lib or _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ldl_launch(a.element_size(), *map(_ptr, (a2, b2, x, work)),
                             a2.shape[0], n, boost, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ldl launch failed: error {err}"
                           + (" (unsupported n or type)" if err == -1 else ""))
    ldl.launches += 1
    return x.reshape(lead + (n,)), work.reshape(a.shape)


def ldl(a, b, boost: float = 0.0):
    """Solve ``a x = b`` for symmetric ``a`` (..., n, n) and ``b`` (..., n)
    by the unpivoted LDLᵀ: the kernel on CUDA tensors, ``ldl_solve`` on CPU
    tensors (``route``)."""
    if route(a.device, a.dtype, a.shape[-1]) == "plain":
        return ldl_solve(a, b, boost)
    return _launch(a, b, boost or torch.finfo(a.dtype).tiny)[0]


ldl.launches = 0  # kernel launches, counted where the kernel launches


def ldl_factors(a, b, boost: float = 0.0):
    """One launch on CUDA tensors: (x, L, d), the solution and the factor
    the kernel's scratch ends holding (L unit lower triangular, d the
    floored pivots), as ``ops/linsolve.py::ldl_factor`` gives them."""
    if route(a.device, a.dtype, a.shape[-1]) != "cuda":
        raise ValueError("ldl_factors: the kernel runs on CUDA tensors")
    x, work = _launch(a, b, boost or torch.finfo(a.dtype).tiny)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return x, torch.tril(work, -1) + eye, work.diagonal(dim1=-2, dim2=-1)


# the clocked build's phases, in the source's order (``csrc/ldl.cu::Phase``)
PHASES = ("trailing_and_load", "panel_factor", "write_back", "forward",
          "backward")


def phase_clocks(a, b, boost: float = 0.0) -> dict:
    """One launch of the clocked build (``-DKKT_PHASE_CLOCKS``) on CUDA
    tensors: the SM clock cycles thread 0 of matrix 0 spent in each of
    ``PHASES``."""
    if route(a.device, a.dtype, a.shape[-1]) != "cuda":
        raise ValueError("ldl: phase clocks run on CUDA tensors")
    lib = _load(phase_clocks=True)
    return cuda_build.clocked(lib, PHASES, a.device, lambda: _launch(
        a, b, boost or torch.finfo(a.dtype).tiny, lib))


# ---- the bound ---------------------------------------------------------------

def work(n: int, batch: int, elem_bytes: int) -> tuple:
    """(floating-point operations, bytes) of one call on ``batch`` matrices
    of n × n, a multiply-add counted as two: the factor's n³/3 (a column's
    n − k − 1 divisions and its trailing update's (n − k − 1)(n − k)/2
    multiply-adds), the two unit triangular solves' 2 n² and the diagonal's
    n divisions. The least work leaves out the product by the pivot that
    the kernel takes once a row, to keep the plain version's rounding (the
    trailing update can take the unscaled column instead). Bytes are the
    lower triangle of ``a`` (all the function reads), ``b`` and ``x`` once;
    the scratch is the kernel's own."""
    factor = sum((n - k - 1) + (n - k - 1) * (n - k) for k in range(n))
    flops = batch * (factor + 2 * n * (n - 1) + n)
    nbytes = batch * elem_bytes * (n * (n + 1) // 2 + 2 * n)
    return flops, nbytes


# NVIDIA H100 SXM, published peaks: outside the tensor cores by the values'
# bytes (float32, float64), and HBM3
PEAK_FLOPS = {4: 67e12, 8: 34e12}
PEAK_BYTES = 3.35e12


def bound_ms(n: int, batch: int, elem_bytes: int):
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    one call, the larger of ``work``'s operations over the card's rate for
    the type and its bytes over the card's memory rate, and which."""
    flops, nbytes = work(n, batch, elem_bytes)
    by = {"operations": 1e3 * flops / PEAK_FLOPS[elem_bytes],
          "bytes": 1e3 * nbytes / PEAK_BYTES}
    which = max(by, key=by.get)
    return by[which], which
