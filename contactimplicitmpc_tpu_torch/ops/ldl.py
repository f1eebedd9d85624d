"""The direct-mode Newton's KKT solve in one launch: wrapper of the Hopper
kernel ``csrc/ldl.cu``.

``ldl(a, b)`` is ``ops/linsolve.py::ldl_solve(a, b)`` for a batch of
symmetric (quasi-definite) matrices ``a`` (..., n, n) and one right-hand
side each, ``b`` (..., n): the unpivoted LDLᵀ with its pivots floored at the
dtype's ``tiny`` (or at ``boost``), then the two triangular solves. The
route is a pure function of the tensors' device, type and n (``route``):
CPU tensors take the plain version, ``ldl_solve`` itself; float32 and
float64 CUDA tensors of an n the source holds (``MAX_N``) launch the
kernel, a thread-block cluster a matrix; anything else on the card raises.
There is no fallback. The kernel's factor is the plain version's,
operation for operation (``csrc/ldl.cu``), so L and d agree bit for bit and
the solution to rounding.

The cluster's geometry follows the source's rule (``cluster_size``,
``shared_bytes``): ``CLUSTER`` CTAs of ``THREADS`` threads where their
shared memory holds the matrix's lower triangle beside a panel copy, else
twice or four times as many (float64 past n = 288 and past n = 384);
``max_active_clusters`` asks the card how many such clusters run at once.

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
# the source's kThreads, kPanel, kCluster, kTileCols, kLd and kMaxN, and an
# H100 CTA's shared bytes
THREADS, PANEL, CLUSTER, TILE_COLS, LD, MAX_N = 512, 32, 4, 8, 33, 480
SHARED_LIMIT = 227 * 1024
DTYPES = (torch.float32, torch.float64)

_LIBS = {}   # phase_clocks: the loaded library


def build(verbose: bool = False, phase_clocks: bool = False) -> str:
    """Compile ``csrc/ldl.cu`` into ``build/`` (``cuda_build.build``),
    with ``phase_clocks`` the build whose CTA 0 of cluster 0 clocks its
    phases (``-DKKT_PHASE_CLOCKS``); returns the library's path."""
    return cuda_build.build(SOURCE, verbose, deps=(CLOCKS_HEADER,),
                            defines=("-DKKT_PHASE_CLOCKS",) if phase_clocks
                            else ())


def rows_a_cta(n: int, cluster: int) -> int:
    """A CTA's rows of an n × n matrix on a cluster of ``cluster`` CTAs
    (row i belongs to CTA i mod cluster)."""
    return (n + cluster - 1) // cluster


def shared_values(n: int, cluster: int) -> int:
    """A CTA's values in shared memory (the source's ``shared_values``): the
    panel copy (``PANEL`` columns of n rows, in runs of ``TILE_COLS``), its
    own rows' panel columns (which the other CTAs pull, in 16-byte runs),
    its rows' lower-triangle entries and right-hand sides (row li in
    cluster · li + cluster + 4 values, 16-byte aligned), the diagonal block
    pushed in and factored, the diagonal blocks it keeps for the backward
    substitution, d, x and the backward's partial sums."""
    rows = rows_a_cta(n, cluster)
    panel_ld = (n + TILE_COLS - 1) // TILE_COLS * TILE_COLS
    mine_ld = (rows + 3) // 4 * 4
    kept = ((n + PANEL - 1) // PANEL + cluster - 1) // cluster
    return (PANEL * panel_ld + PANEL * mine_ld + rows * (cluster + 4)
            + cluster * rows * (rows - 1) // 2 + 2 * PANEL * LD
            + kept * PANEL * LD + 3 * n)


def cluster_size(n: int, elem_bytes: int) -> int:
    """The source's rule (``cluster_size``): the smallest of ``CLUSTER``,
    2 ``CLUSTER`` and 4 ``CLUSTER`` CTAs a matrix whose shared memory holds
    it."""
    for cluster in (CLUSTER, 2 * CLUSTER):
        if elem_bytes * shared_values(cluster=cluster, n=n) <= SHARED_LIMIT:
            return cluster
    return 4 * CLUSTER


def shared_bytes(n: int, elem_bytes: int) -> int:
    """A CTA's shared bytes for an n × n matrix, on the cluster
    ``cluster_size`` picks."""
    return elem_bytes * shared_values(n, cluster_size(n, elem_bytes))


def _load(phase_clocks: bool = False):
    if phase_clocks not in _LIBS:
        lib = ctypes.CDLL(build(phase_clocks=phase_clocks))
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.ldl_geometry.restype = i32
        lib.ldl_geometry.argtypes = [i32, i32, ptr]
        lib.ldl_max_active_clusters.restype = i32
        lib.ldl_max_active_clusters.argtypes = [i32, i32, ptr]
        lib.ldl_launch.restype = i32
        lib.ldl_launch.argtypes = [i32] + [ptr] * 4 + [i32, i32, f64, ptr]
        for n in (1, 100, 300, MAX_N):
            for elem in (4, 8):
                got = geometry(n, elem, lib)
                want = {"cluster": cluster_size(n, elem),
                        "shared_bytes": shared_bytes(n, elem),
                        "threads": THREADS,
                        "rows": rows_a_cta(n, cluster_size(n, elem))}
                if got != want:
                    raise RuntimeError(f"ldl: the kernel's geometry at n = {n}, "
                                       f"{elem}-byte values is {got}, the "
                                       f"wrapper's {want}")
        if phase_clocks:
            cuda_build.bind_clocks(lib)
        _LIBS[phase_clocks] = lib
    return _LIBS[phase_clocks]


def geometry(n: int, elem_bytes: int, lib=None) -> dict:
    """The kernel's own geometry for an n × n matrix (``ldl_geometry``):
    the cluster's CTAs, a CTA's shared bytes, threads and rows."""
    lib = lib or _load()
    out = (ctypes.c_int * 4)()
    if lib.ldl_geometry(elem_bytes, n, out) != 0:
        raise ValueError(f"ldl: n = {n} is outside what the kernel holds")
    return dict(zip(("cluster", "shared_bytes", "threads", "rows"), out))


def max_active_clusters(n: int, elem_bytes: int) -> int:
    """How many clusters of the geometry for an n × n matrix the card runs
    at once (``cudaOccupancyMaxActiveClusters``); on the GPU."""
    out = ctypes.c_int(0)
    err = _load().ldl_max_active_clusters(elem_bytes, n, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"ldl: cudaOccupancyMaxActiveClusters failed: "
                           f"error {err}")
    return out.value


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


# the clocked build's phases, in the source's order (``csrc/ldl.cu::Phase``);
# a panel's are summed over the panels
PHASES = ("load", "diag_factor", "row_elimination", "panel_exchange",
          "trailing_update", "diag_push", "write_out", "solves")


def phase_clocks(a, b, boost: float = 0.0) -> dict:
    """One launch of the clocked build (``-DKKT_PHASE_CLOCKS``) on CUDA
    tensors: the SM clock cycles thread 0 of CTA 0 of cluster 0 spent in
    each of ``PHASES``."""
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
