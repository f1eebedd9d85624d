"""The batched knot interior-point solve: wrapper of the Hopper kernel
``csrc/knot_ip.cu``.

Counterpart of ``contactimplicitmpc_tpu/ops/pallas_ip.py``
(``linearized_ip_fixed_pallas`` and its ``_ip_kernel``), with the whole
contract of ``ops/fixed_ip.py::linearized_ip_fixed`` (sensitivities
included). On CPU tensors it runs that plain version; on CUDA tensors it
launches the kernel or raises — there is no fallback.

Shapes: the linearization tensors are per knot, ``(K, ...)``; the
per-problem tensors ``alt``, ``theta`` and ``q2_init`` are ``(..., K, f)``,
so problem ``(..., k)`` uses knot ``k``.

A call is two kernels on one stream, counted as one launch: a prologue
that packs each knot's constants (``pack_knots``; its plain version
``pack_knots_plain`` and the layout ``pack_layout`` are here), then the
solve, whose blocks each read one knot's packed block. The kernel has two
templates: a warp a problem where the knot fits a warp, a block a problem
past it (the 3D models); ``warp_template`` says which one takes a model,
and ``KNOT_IP_MODELS``/``KNOT_IP_WIDE_MODELS`` list what the build holds:
every model of the JAX package. Dimensions in neither table raise on CUDA
tensors.

``work`` counts the operations and bytes of a call, and ``bound_ms`` turns
them into the kernel's bound on an H100.

The kernel is compiled from the repository's source with ``nvcc`` at first
use into ``build/`` (``cuda_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from ..dims import Dims
from ..sim.interior_point import IPOptions
from ..utils.spans import span
from . import cuda_build
from .cuda_build import CSRC
from .fixed_ip import FixedIPResult, knot_blocks, linearized_ip_fixed

SOURCE = os.path.join(CSRC, "knot_ip.cu")

_lib = None


def build(verbose: bool = False) -> str:
    """Compile ``csrc/knot_ip.cu`` into ``build/`` (``cuda_build.build``);
    returns the library's path."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.knot_ip_pack_floats.restype = i32
        lib.knot_ip_pack_floats.argtypes = [i32] * 4
        lib.knot_ip_pack_launch.restype = i32
        lib.knot_ip_pack_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.knot_ip_launch.restype = i32
        lib.knot_ip_launch.argtypes = ([ptr] * 14 + [i32] * 9 + [f32] * 6
                                       + [ptr])
        _lib = lib
    return _lib


# ---- the per-knot packed constants ---------------------------------------

def _pad4(n: int) -> int:
    return (n + 3) & ~3


class PackLayout(NamedTuple):
    """One knot's packed block, as the kernel lays it out (in floats):
    ``struct Lay`` for problems a warp holds, ``struct WLay`` past them
    (``warp_template``). ``blocks[name]`` is (offset, rows, row stride,
    columns); what lies past a row's columns is zero. ``slots[j]`` is the
    padded position of variable (or residual row) ``j``: for ``Lay`` the
    ``x`` part is padded to a multiple of 4 so that the ``y1`` and ``y2``
    parts start 16-byte aligned; ``WLay`` pads no slot."""
    blocks: dict
    slots: tuple
    size: int


# The instantiations the build holds, mirroring the two tables of
# csrc/knot_ip.cu (a test parses them and holds them to these):
# (nx, ny, ntheta, nc) on the model's flat terrain → the models of the JAX
# package that give those dimensions.
KNOT_IP_MODELS = {          # struct Lay, a warp a problem
    (11, 16, 34, 4): ("quadruped", "quadruped_payload"),
    (4, 4, 14, 1): ("hopper_2D",),
    (9, 16, 28, 4): ("flamingo",),
    (2, 4, 10, 1): ("particle_2D",),
    (2, 8, 10, 2): ("pushbot",),
    (4, 8, 15, 2): ("walledcartpole",),
}
KNOT_IP_WIDE_MODELS = {     # struct WLay, a block a problem
    (18, 24, 53, 4): ("centroidal_quadruped", "centroidal_quadruped_undamped",
                      "centroidal_quadruped_box", "point_foot_quadruped"),
    (3, 6, 14, 1): ("particle",),
    (7, 6, 22, 1): ("hopper_3D",),
    (18, 48, 53, 8): ("centroidal_quadruped_wall",
                      "centroidal_quadruped_wall_slanted"),
}


def warp_template(dims: Dims) -> bool:
    """Whether the kernel takes ``dims`` with one warp a problem (``struct
    Lay``'s assertions); past them it takes a block a problem (``struct
    WLay``), with a layout of its own. The warp template holds the
    quadruped (and its payload variant), the 2D hopper, the flamingo, the
    2D particle, the pushbot and the walled cartpole; the block template
    the centroidal quadruped family and the point-foot quadruped, the 3D
    particle, the 3D hopper and the centroidal quadruped at the wall
    (``KNOT_IP_MODELS``, ``KNOT_IP_WIDE_MODELS``)."""
    nx, ny = dims.nx, dims.ny
    return (ny % 4 == 0 and 2 * ny <= 32 and nx <= ny and nx + ny <= 32
            and dims.ntheta <= 34)


@functools.lru_cache(maxsize=None)
def pack_layout(dims: Dims) -> PackLayout:
    if not warp_template(dims):
        return _pack_layout_wide(dims)
    nx, ny, nz, nt = dims.nx, dims.ny, dims.nz, dims.ntheta
    ne = nx + ny
    vy1 = _pad4(nx)
    nv = vy1 + 2 * ny
    xs, ys = _pad4(nx), ny + 4
    blocks, off = {}, 0
    for name, rows, stride, cols in (
            ("rza", ne, nv, nv),        # equality rows of rz0, padded columns
            ("dxi", nx, xs, nx),        # Dx⁻¹
            ("dy1", nx, ys, ny),
            ("dxdy", nx, ys, ny),       # Dx⁻¹ Dy1
            ("cai", ny, xs, nx),        # Rx Dx⁻¹
            ("sb", ny, ny, ny),         # Ry1 − Rx Dx⁻¹ Dy1
            ("ry1d", 1, ny, ny),        # diagonal of Ry1
            ("caibd", 1, ny, ny),       # diagonal of Rx Dx⁻¹ Dy1
            ("ry2", 1, ny, ny),         # diagonal of Ry2
            ("z0", 1, nv, nv),          # padded
            ("r0", 1, _pad4(ne), ne),   # equality rows of r0
            ("theta0", 1, _pad4(nt), nt),
            ("rtheta0", 1, _pad4(nz * nt), nz * nt)):
        blocks[name] = (off, rows, stride, cols)
        off += rows * stride
    slots = tuple(j if j < nx else j + vy1 - nx for j in range(nz))
    return PackLayout(blocks=blocks, slots=slots, size=off)


def _pack_layout_wide(dims: Dims) -> PackLayout:
    """``struct WLay``'s block: rows at an odd stride, no slot padding, the
    total rounded up to 16 bytes."""
    nx, ny, nz, nt = dims.nx, dims.ny, dims.nz, dims.ntheta
    ne = nx + ny
    odd = lambda n: n | 1
    blocks, off = {}, 0
    for name, rows, stride, cols in (
            ("rza", ne, odd(nz), nz),   # equality rows of rz0
            ("dxi", nx, odd(nx), nx),   # Dx⁻¹
            ("dy1", nx, odd(ny), ny),
            ("cai", ny, odd(nx), nx),   # Rx Dx⁻¹
            ("sb", ny, odd(ny), ny),    # Ry1 − Rx Dx⁻¹ Dy1
            ("ry1d", 1, ny, ny),        # diagonal of Ry1
            ("caibd", 1, ny, ny),       # diagonal of Rx Dx⁻¹ Dy1
            ("ry2", 1, ny, ny),         # diagonal of Ry2
            ("z0", 1, nz, nz),
            ("r0", 1, ne, ne),          # equality rows of r0
            ("theta0", 1, nt, nt),
            ("rtheta0", 1, nz * nt, nz * nt)):
        blocks[name] = (off, rows, stride, cols)
        off += rows * stride
    return PackLayout(blocks=blocks, slots=tuple(range(nz)), size=_pad4(off))


def pack_blocks(dims: Dims, pack) -> dict:
    """Views ``name → (K, rows, columns)`` into a packed tensor
    ``(K, size)``, the row padding cut off."""
    out = {}
    for name, (off, rows, stride, cols) in pack_layout(dims).blocks.items():
        out[name] = pack[:, off:off + rows * stride].view(
            pack.shape[0], rows, stride)[:, :, :cols]
    return out


def pack_knots_plain(dims: Dims, z0_lin, theta0, r0, rz0, rtheta0):
    """The packed per-knot constants ``(K, size)`` in plain PyTorch, from
    the blocks ``ops/fixed_ip.py`` forms."""
    lay = pack_layout(dims)
    ne = dims.nx + dims.ny
    k = rz0.shape[0]
    b = knot_blocks(dims, rz0)
    pack = rz0.new_zeros((k, lay.size))
    views = pack_blocks(dims, pack)
    slots = torch.as_tensor(lay.slots, device=rz0.device)
    views["rza"][:, :, slots] = rz0[:, :ne, :]
    views["z0"][:, 0, slots] = z0_lin
    diag = lambda m: torch.diagonal(m, dim1=-2, dim2=-1)
    for name, x in (("dxi", b.dxi), ("dy1", b.dy1),
                    ("dxdy", b.dxi @ b.dy1), ("cai", b.cai),
                    ("sb", b.ry1 - b.caib), ("ry1d", diag(b.ry1)),
                    ("caibd", diag(b.caib)), ("ry2", b.ry2),
                    ("r0", r0[:, :ne]), ("theta0", theta0),
                    ("rtheta0", rtheta0.reshape(k, -1))):
        if name in views:
            views[name][:] = x.reshape(views[name].shape)
    return pack


def _check(device, expect):
    for name, (t, shape) in expect.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"knot_ip: {name} must be float32 on {device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"knot_ip: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"knot_ip: {name} must be contiguous")


def _knot_shapes(dims: Dims, z0_lin, theta0, r0, rz0, rtheta0):
    n_knot, nz, nt = z0_lin.shape[0], dims.nz, dims.ntheta
    return {"z0_lin": (z0_lin, (n_knot, nz)), "theta0": (theta0, (n_knot, nt)),
            "r0": (r0, (n_knot, nz)), "rz0": (rz0, (n_knot, nz, nz)),
            "rtheta0": (rtheta0, (n_knot, nz, nt))}


def _raise_on(err: int, what: str):
    if err != 0:
        reason = {-1: " (unsupported dims)", -2: " (unsupported arguments)"}
        raise RuntimeError(f"knot_ip {what} launch failed: error {err}"
                           + reason.get(err, ""))


@functools.lru_cache(maxsize=None)
def _pack_floats(dims: Dims) -> int:
    """The kernel's packed floats a knot, held against ``pack_layout``."""
    size = _load().knot_ip_pack_floats(dims.nx, dims.ny, dims.ntheta, dims.nc)
    _raise_on(min(size, 0), "pack")
    if size != pack_layout(dims).size:
        raise RuntimeError(f"knot_ip: the kernel packs {size} floats a knot, "
                           f"pack_layout {pack_layout(dims).size}")
    return size


def _pack_scratch(dims: Dims, n_knot: int, device):
    return torch.empty((n_knot, _pack_floats(dims)), dtype=torch.float32,
                       device=device)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def pack_knots(dims: Dims, z0_lin, theta0, r0, rz0, rtheta0):
    """The packed per-knot constants ``(K, size)``: the kernel's prologue
    alone for CUDA tensors, ``pack_knots_plain`` for CPU tensors."""
    knots = (z0_lin, theta0, r0, rz0, rtheta0)
    if not rz0.is_cuda:
        return pack_knots_plain(dims, *knots)
    _check(rz0.device, _knot_shapes(dims, *knots))
    lib = _load()
    pack = _pack_scratch(dims, rz0.shape[0], rz0.device)
    with torch.cuda.device(rz0.device):
        stream = torch.cuda.current_stream(rz0.device).cuda_stream
        err = lib.knot_ip_pack_launch(
            *map(_ptr, knots + (pack,)), rz0.shape[0], dims.nx, dims.ny,
            dims.ntheta, dims.nc, ctypes.c_void_p(stream))
    _raise_on(err, "pack")
    return pack


# ---- the solve --------------------------------------------------------------

def _launch(dims: Dims, z0_lin, theta0, r0, rz0, rtheta0, alt, theta,
            q2_init, opts: IPOptions, iters: int) -> FixedIPResult:
    n_knot = z0_lin.shape[0]
    lead = theta.shape[:-1]
    nz, nt = dims.nz, dims.ntheta
    expect = _knot_shapes(dims, z0_lin, theta0, r0, rz0, rtheta0)
    expect.update({"alt": (alt, lead + (dims.nc,)),
                   "theta": (theta, lead + (nt,)),
                   "q2_init": (q2_init, lead + (dims.nq,))})
    device = theta.device
    _check(device, expect)
    if not lead or lead[-1] != n_knot:
        raise ValueError(f"knot_ip: per-problem shape {lead} must end in the "
                         f"knot count {n_knot}")
    n = theta.numel() // nt
    lib = _load()
    pack = _pack_scratch(dims, n_knot, device)
    z = torch.empty(lead + (nz,), dtype=torch.float32, device=device)
    conv = torch.empty(lead, dtype=torch.bool, device=device)
    rvio = torch.empty(lead, dtype=torch.float32, device=device)
    kvio = torch.empty(lead, dtype=torch.float32, device=device)
    dz = torch.empty(lead + (nz, nt), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.knot_ip_launch(
            *map(_ptr, (z0_lin, theta0, r0, rz0, rtheta0, alt, theta, q2_init,
                        pack, z, conv, rvio, kvio, dz)),
            n, n_knot, dims.nx, dims.ny, nt, dims.nc, iters, opts.refine,
            opts.max_ls, opts.r_tol, opts.kappa_tol,
            opts.kappa_tol / opts.undercut, opts.gamma_reg, opts.tau_min,
            opts.tau_max, ctypes.c_void_p(stream))
    _raise_on(err, "kernel")
    knot_ip.launches += 1
    return FixedIPResult(z=z, converged=conv, rvio=rvio, kvio=kvio, dz=dz)


def knot_ip(dims: Dims, z0_lin, theta0, r0, rz0, rtheta0, alt, theta,
            q2_init, opts: IPOptions, iters: int = 10) -> FixedIPResult:
    """Batched fixed-iteration knot solve: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if theta.is_cuda:
        with span("knot_ip", theta):
            return _launch(dims, z0_lin, theta0, r0, rz0, rtheta0, alt, theta,
                           q2_init, opts, iters)
    return linearized_ip_fixed(dims, z0_lin, theta0, r0, rz0, rtheta0, alt,
                               theta, q2_init, opts, iters)


knot_ip.launches = 0  # kernel launches, counted where the kernel launches


# ---- the bound -------------------------------------------------------------

def work(dims: Dims, n: int, k: int, iters: int, refine: int,
         max_ls: int) -> tuple:
    """(floating-point operations, bytes) of one call on ``n`` problems
    over ``k`` knots.

    Operations are the least the function needs, a multiply-add counted as
    two, the per-knot constants once a knot: an in-place Gauss-Jordan
    inverse (2 m³, not the 4 m³ of an m × 2m tableau), and a line search
    whose 2 (max_ls + 1) candidates share two Jacobian products, because
    the equality rows of the merit are affine in the step length
    (``ops/fixed_ip.py`` evaluates each candidate with a product of its
    own; counted that way a quadruped problem would need ~667 kflop, not
    ~479). All ``iters`` iterations are counted: the solve is a
    fixed-iteration one that masks converged problems and still computes
    them, as the JAX package's does. Bytes are every input and every
    output once; the packed scratch is the kernel's own and is not counted.
    """
    nx, ny, nz, nt = dims.nx, dims.ny, dims.nz, dims.ntheta
    ne = nx + ny
    gauss_jordan = lambda m: 2 * m * m * m        # m pivots on m × m, in place
    schur = 2 * (ny * nx + ny * ny + nx * ny + nx * nx) + 6 * ny
    apply_jac = 2 * ne * nz + 3 * ny + nz         # and the subtraction from rhs
    solve = schur + refine * (apply_jac + schur + nz)
    residual = 2 * ne * nz + nz + ne + 2 * ny
    candidate = 4 * ne + 8 * ny                   # r − α Jd, the products, squares
    search = 2 * (2 * ne * nz) + 2 * (max_ls + 1) * candidate + 2 * nz
    factor = gauss_jordan(ny) + 3 * ny + ny * ny
    steps = 3 * 4 * ny + 8 * ny + 3 * ny          # step lengths, μ, right-hand sides
    iteration = residual + factor + 3 * solve + search + steps
    final = residual + factor + nt * solve
    per_problem = 2 * ne * nt + nt + 2 * ne + iters * iteration + final
    per_knot = gauss_jordan(nx) + 2 * ny * nx * nx + 2 * ny * ny * nx
    flops = n * per_problem + k * per_knot
    bytes_in = 4 * n * (nt + dims.nq + dims.nc) \
        + 4 * k * (nz + nt + nz + nz * nz + nz * nt)
    bytes_out = n * (4 * (nz + nz * nt + 2) + 1)
    return flops, bytes_in + bytes_out


# NVIDIA H100 SXM, published peaks: float32 outside the tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def bound_ms(dims: Dims, n: int, k: int, iters: int, opts: IPOptions):
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    one call, the larger of ``work``'s operations over the card's float32
    rate and its bytes over the card's memory rate, and which of the two."""
    flops, nbytes = work(dims, n, k, iters, opts.refine, opts.max_ls)
    by = {"operations": 1e3 * flops / PEAK_FLOPS,
          "bytes": 1e3 * nbytes / PEAK_BYTES}
    which = max(by, key=by.get)
    return by[which], which
