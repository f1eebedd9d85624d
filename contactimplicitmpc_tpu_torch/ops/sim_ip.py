"""The sim step in one launch: wrapper of the Hopper kernels of
``csrc/sim_ip.cuh`` (the block interior-point solve a model's residual is
plugged into) and ``csrc/sim_ip.cu`` (the quadruped's residual and
Jacobian).

``sim_ip(model, env, z0, θ, opts)`` solves one sim step's contact NCP for
a batch of problems, ``z0`` (B, nz) and ``θ`` (B, nθ), with a block of 256
threads a problem (the header sets its shared memory), and returns what ``sim.interior_point.ip_solve`` returns for the
same arguments (``IPResult``, no sensitivities). ``KERNELS`` says which
(model class, terrain) pairs have a kernel, with its source, widths and
packing; ``sim.graphs.SimSolve`` asks ``takes`` and sends every other pair
to its replayed graphs. Today it holds one pair, a
``models.quadruped.Quadruped`` on ``env.flat_2d_lc``. A kernel takes
float32 or float64 CUDA tensors and raises on anything else, the CPU
included: its plain version is ``ip_solve`` itself, which ``SimSolve`` runs
on CPU tensors. The model's constants go to the kernel as one packed
float64 table (``pack_quadruped``), so that every ``Quadruped`` shares one
build. The quadruped's kernel computes in float64 for both tensor types and
rounds its outputs to theirs (``csrc/sim_ip.cu`` says why); a build that
computes float32 problems in float32 (``arithmetic="float32"``) exists for
``tools/sim_ip_f32_stall.py`` alone.

``work`` counts the operations and bytes of a call of the quadruped's
kernel from the trips its problems took, and ``bound_ms`` turns them into
the kernel's bound on an H100 at the tensors' type. ``phase_clocks`` runs
a build that clocks a solve's phases (``tools/sim_ip_phases.py``).

A kernel is compiled from the repository's sources with ``nvcc`` at first
use into ``build/`` (``cuda_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from ..env import flat_2d_lc
from ..models.quadruped import Quadruped
from ..sim.interior_point import IPOptions, IPResult
from . import cuda_build
from .cuda_build import CSRC

HEADER = os.path.join(CSRC, "sim_ip.cuh")
MAX_LS = 63          # the kernel's largest max_ls: 128 candidates
ARITHMETIC = ("float64", "float32")   # what a float32 problem computes in


# ---- the packed quadruped ---------------------------------------------------

# (name, shape) in the kernel's order (csrc/sim_ip.cu, P_ARMS ... P_AF); the
# last three list the lever arms' nonzeros (``sparse_arms``)
POINT_ANGLES, ANGLE_BODIES, ANGLE_FEET = 3, 5, 2   # the lists' widths
PACK_LAYOUT = (("arms", (13, 9)), ("masses", (9,)), ("inertias", (9,)),
               ("joint_friction", (11,)), ("control_jacobian", (8, 11)),
               ("disturbance_jacobian", (2, 11)), ("g", ()),
               ("point_angles", (13, 1 + 2 * POINT_ANGLES)),
               ("angle_bodies", (9, 1 + 2 * ANGLE_BODIES)),
               ("angle_feet", (9, 1 + 2 * ANGLE_FEET)))
PACK_SIZE = sum(int(np.prod(shape)) for _, shape in PACK_LAYOUT)
# the model's constants without the lists (what ``work`` counts: the lists
# re-encode the lever arms for the kernel)
CONSTANTS_SIZE = sum(int(np.prod(shape)) for _, shape in PACK_LAYOUT[:7])


def _lists(arms: np.ndarray, width: int) -> np.ndarray:
    """Each row's nonzeros as (count, index₀, arm₀, index₁, arm₁, …) in
    ascending index, padded with zeros to ``width`` pairs; raises where a
    row has more."""
    out = np.zeros((arms.shape[0], 1 + 2 * width))
    for r, row in enumerate(arms):
        idx = np.flatnonzero(row)
        if len(idx) > width:
            raise ValueError(f"sim_ip: {len(idx)} lever arms in a row, the "
                             f"kernel's lists take {width}")
        out[r, 0] = len(idx)
        out[r, 1:1 + 2 * len(idx):2] = idx
        out[r, 2:2 + 2 * len(idx):2] = row[idx]
    return out


def sparse_arms(arms: np.ndarray) -> dict:
    """The lever arms' (13 × 9) nonzeros as the kernel's lists: each
    point's angles, each angle's bodies (points 0-8) and each angle's feet
    (points 9-12)."""
    arms = np.asarray(arms, dtype=np.float64)
    return {"point_angles": _lists(arms, POINT_ANGLES),
            "angle_bodies": _lists(arms[:9].T, ANGLE_BODIES),
            "angle_feet": _lists(arms[9:].T, ANGLE_FEET)}


def pack_quadruped(model: Quadruped) -> np.ndarray:
    """The constants of ``model`` the kernel's residual reads, as one
    float64 vector in ``PACK_LAYOUT``'s order, each read from the model:
    the lever arms of the nine bodies and four feet over the nine absolute
    angles, the bodies' masses and inertias, the joint friction, B, A and
    g, and the lever arms' nonzeros as lists (``sparse_arms``). (The
    friction rows read μ from θ, as ``sim/residual.py`` does.)"""
    q = torch.zeros(model.nq, dtype=torch.float64)
    values = {"arms": model._arms, "masses": model._masses,
              "inertias": model._inertias,
              "joint_friction": model.joint_friction,
              "control_jacobian": model._b,
              "disturbance_jacobian": model.disturbance_jacobian(q).numpy(),
              "g": model.g, **sparse_arms(model._arms)}
    parts = []
    for name, shape in PACK_LAYOUT:
        x = np.asarray(values[name], dtype=np.float64)
        if x.shape != shape:
            raise ValueError(f"sim_ip: {name} has shape {x.shape}, expected "
                             f"{shape}")
        parts.append(x.reshape(-1))
    return np.concatenate(parts)


# ---- the table of kernels ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimKernel:
    """A model's sim kernel: its source (the model's residual over
    ``sim_ip.cuh``), its widths (x, y, θ) and how a model is packed."""
    source: str
    nx: int
    ny: int
    nt: int
    pack: Callable[[object], np.ndarray]
    pack_size: int

    @property
    def nz(self) -> int:
        return self.nx + 2 * self.ny


# (model class, terrain) → its kernel; every other pair takes the graphs.
KERNELS = {
    (Quadruped, flat_2d_lc): SimKernel(
        os.path.join(CSRC, "sim_ip.cu"), nx=11, ny=16, nt=34,
        pack=pack_quadruped, pack_size=PACK_SIZE),
}
QUADRUPED = KERNELS[Quadruped, flat_2d_lc]


def kernel_for(model, env) -> SimKernel | None:
    """The kernel of ``model``'s class on ``env`` (``KERNELS``), or None."""
    return KERNELS.get((type(model), env))


def takes(model, env) -> bool:
    """Whether a kernel takes the sim steps of ``model`` on ``env``."""
    return kernel_for(model, env) is not None


def build(kernel: SimKernel = QUADRUPED, arithmetic: str = "float64",
          verbose: bool = False, phase_clocks: bool = False) -> str:
    """Compile ``kernel``'s source into ``build/`` (``cuda_build.build``);
    with ``arithmetic="float32"`` its float32 problems compute in float32,
    with ``phase_clocks`` one thread of problem 0 clocks the solve's phases
    (``-DSIM_IP_PHASE_CLOCKS``, ``phase_clocks``; the sim steps never ask
    for it). Returns the library's path."""
    defines = ((("-DSIM_IP_FLOAT32_ARITHMETIC",) if arithmetic == "float32"
                else ())
               + (("-DSIM_IP_PHASE_CLOCKS",) if phase_clocks else ()))
    return cuda_build.build(kernel.source, verbose, deps=(HEADER,),
                            defines=defines)


_LIBS = {}   # (source, arithmetic, phase_clocks): the loaded library


def _load(kernel: SimKernel, arithmetic: str, phase_clocks: bool = False):
    key = (kernel.source, arithmetic, phase_clocks)
    if key not in _LIBS:
        lib = ctypes.CDLL(build(kernel, arithmetic, phase_clocks=phase_clocks))
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("sim_ip_pack_size", "sim_ip_float32_arithmetic_bytes"):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = []
        lib.sim_ip_launch.restype = i32
        lib.sim_ip_launch.argtypes = ([i32] + [ptr] * 8 + [i32] * 6
                                      + [f64] * 7 + [ptr])
        size = lib.sim_ip_pack_size()
        if size != kernel.pack_size:
            raise RuntimeError(f"sim_ip: the kernel packs {size} values, "
                               f"the wrapper {kernel.pack_size}")
        width = lib.sim_ip_float32_arithmetic_bytes()
        if width != (4 if arithmetic == "float32" else 8):
            raise RuntimeError(f"sim_ip: the {arithmetic} build computes "
                               f"float32 problems in {width}-byte values")
        if phase_clocks:
            lib.sim_ip_clock_slots.restype = i32
            lib.sim_ip_clocks_reset.restype = i32
            lib.sim_ip_clocks_read.restype = i32
            lib.sim_ip_clocks_read.argtypes = [ptr]
        _LIBS[key] = lib
    return _LIBS[key]


_PACKS = {}   # (model, device): the packed table on the device


def _packed(model, kernel: SimKernel, device):
    """``kernel.pack(model)`` as a float64 tensor on ``device``, made once
    per (model, device)."""
    key = (model, torch.device(device))
    if key not in _PACKS:
        _PACKS[key] = torch.as_tensor(kernel.pack(model), device=device)
    return _PACKS[key]


# ---- the call ----------------------------------------------------------------

def _check(model, env, z0, theta, opts: IPOptions,
           arithmetic: str) -> SimKernel:
    kernel = kernel_for(model, env)
    if kernel is None:
        raise ValueError(f"sim_ip: no kernel takes {type(model).__name__} "
                         f"on this terrain (KERNELS: a Quadruped on "
                         f"flat_2d_lc)")
    if opts.diff_sol:
        raise ValueError("sim_ip: no sensitivities (diff_sol): no sim step "
                         "asks for them")
    if not 0 <= opts.max_ls <= MAX_LS:
        raise ValueError(f"sim_ip: max_ls {opts.max_ls} outside [0, {MAX_LS}]")
    for name in ("fixed_iters", "max_iter", "retries", "refine"):
        if getattr(opts, name) < 0:
            raise ValueError(f"sim_ip: {name} must be ≥ 0")
    if z0.dtype not in (torch.float32, torch.float64) or theta.dtype != z0.dtype:
        raise ValueError(f"sim_ip: z0 and theta must share float32 or "
                         f"float64, got {z0.dtype} and {theta.dtype}")
    if arithmetic not in ARITHMETIC:
        raise ValueError(f"sim_ip: arithmetic {arithmetic!r} not in "
                         f"{ARITHMETIC}")
    if arithmetic == "float32" and z0.dtype != torch.float32:
        raise ValueError("sim_ip: float32 arithmetic is for float32 tensors")
    if theta.device != z0.device:
        raise ValueError("sim_ip: z0 and theta must share a device")
    nz, nt = kernel.nz, kernel.nt
    if z0.dim() != 2 or z0.shape[1] != nz or tuple(theta.shape) != (
            z0.shape[0], nt):
        raise ValueError(f"sim_ip: z0 (B, {nz}) and theta (B, {nt}) expected, "
                         f"got {tuple(z0.shape)} and {tuple(theta.shape)}")
    if not (z0.is_contiguous() and theta.is_contiguous()):
        raise ValueError("sim_ip: z0 and theta must be contiguous")
    if not z0.is_cuda:
        raise ValueError("sim_ip: the kernel runs on CUDA tensors; on the CPU "
                         "the sim step is sim.interior_point.ip_solve")
    return kernel


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def sim_ip(model, env, z0, theta, opts: IPOptions,
           arithmetic: str = "float64") -> IPResult:
    """``ip_solve(dims_of(model, env), residual of model on env, z0, θ,
    opts)`` in one launch of the kernel of ``model`` on ``env``, for CUDA
    tensors; raises on what the kernel does not take (``_check``) and on a
    failed launch. ``arithmetic="float32"`` computes float32 problems in
    float32 (a build of its own; no sim step asks for it)."""
    kernel = _check(model, env, z0, theta, opts, arithmetic)
    return _launch(_load(kernel, arithmetic), kernel, model, z0, theta, opts)


def _launch(lib, kernel: SimKernel, model, z0, theta,
            opts: IPOptions) -> IPResult:
    pack = _packed(model, kernel, z0.device)
    n = z0.shape[0]
    z = torch.empty_like(z0)
    conv = torch.empty((n,), dtype=torch.bool, device=z0.device)
    iters = torch.empty((n,), dtype=torch.int32, device=z0.device)
    rvio = torch.empty((n,), dtype=z0.dtype, device=z0.device)
    kvio = torch.empty_like(rvio)
    with torch.cuda.device(z0.device):
        stream = torch.cuda.current_stream(z0.device).cuda_stream
        err = lib.sim_ip_launch(
            z0.element_size(), *map(_ptr, (pack, z0, theta, z, conv, iters,
                                           rvio, kvio)),
            n, opts.fixed_iters, opts.max_iter, opts.retries, opts.refine,
            opts.max_ls, opts.r_tol, opts.kappa_tol,
            opts.kappa_tol / opts.undercut, opts.gamma_reg, opts.tau_min,
            opts.tau_max, opts.eps_min, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sim_ip launch failed: error {err}"
                           + (" (unsupported arguments)" if err == -2 else ""))
    sim_ip.launches += 1
    return IPResult(z=z, converged=conv, iterations=iters, rvio=rvio,
                    kvio=kvio, dz=None)


sim_ip.launches = 0  # kernel launches, counted where the kernel launches

# the clocked build's slots: the phases, then the whole solve and its trips
PHASES = ("trig_jacobian", "schur", "solves", "candidates", "bookkeeping",
          "start_finish")


def phase_clocks(model, env, z0, theta, opts: IPOptions,
                 arithmetic: str = "float64") -> dict:
    """One launch of the clocked build (``-DSIM_IP_PHASE_CLOCKS``) on
    (``z0``, ``θ``): the SM clock cycles problem 0 spent in each of
    ``PHASES``, in the whole solve (``"total"``) and its trips
    (``"trips"``), as one thread of problem 0 read them with ``clock64()``
    at the block's barriers."""
    kernel = _check(model, env, z0, theta, opts, arithmetic)
    lib = _load(kernel, arithmetic, phase_clocks=True)
    slots = lib.sim_ip_clock_slots()
    if slots != len(PHASES) + 2:
        raise RuntimeError(f"sim_ip: the clocked build has {slots} slots")
    torch.cuda.synchronize(z0.device)
    if lib.sim_ip_clocks_reset() != 0:
        raise RuntimeError("sim_ip: clearing the phase clocks failed")
    _launch(lib, kernel, model, z0, theta, opts)
    torch.cuda.synchronize(z0.device)
    out = (ctypes.c_longlong * slots)()
    if lib.sim_ip_clocks_read(out) != 0:
        raise RuntimeError("sim_ip: reading the phase clocks failed")
    return dict(zip(PHASES + ("total", "trips"), map(int, out)))


# ---- the bound ---------------------------------------------------------------

# The closed-form Jacobian's operations (csrc/sim_ip.cu::jacobian) over the
# quadruped's lever arms: 17 body entries (a body hangs on 1-3 angles) and
# 10 foot entries. The bodies' force derivatives, ≈ 30 an entry and one
# along x and one along z a body; the dynamics rows along q2, the x and z
# rows a sum of the 9 bodies along x or z and of the 17 entries, an angle's
# row 71 terms of four (each (angle, body) entry over the body's x, z and
# angles: Σ_b angles_b (2 + angles_b)); the diagonal's own terms (the joint
# damping, the forces' rotation over the 17 entries, the inertia, the feet's
# forces over the 10); the contact columns, the impact rows and the
# dissipation rows over the 10 foot entries; the friction cone's 4.
JACOBIAN_CLOSED_FORM = ((17 * 30 + 2 * 9) + 2 * (9 + 17) + 71 * 4
                        + (11 + 17 * 4 + 9 * 3 + 10 * 6) + 10 * 5 + 10
                        + (8 + 2 * 10 * 6) + 4)
RESIDUAL = 630   # a residual's equality rows over the same lever arms
JACOBIAN = {"closed_form": JACOBIAN_CLOSED_FORM,
            "dual": 27 * 3 * RESIDUAL}


def work(n: int, trips: int, max_ls: int, refine: int, elem_bytes: int,
         jacobian: str = "closed_form") -> tuple:
    """(floating-point operations, bytes) of one call of the quadruped's
    kernel on ``n`` problems of ``elem_bytes`` a value that took ``trips``
    trips in all (the sum of their iteration counts: what this run's data
    needed), a multiply-add counted as two and a sine or cosine as one.

    A residual's equality rows over the quadruped's sparse lever arms (17
    body and 10 foot entries) cost ≈ 630 operations; the Jacobian of the 27
    equality rows in (x, y1) ``JACOBIAN[jacobian]``: its closed form
    (≈ 1.2k, what the function needs), or with ``jacobian="dual"`` the
    forward-mode evaluation of the residual along 27 directions (a dual
    product three operations, a sum two: ≈ 3 × 630 a direction) that the
    earlier one-warp kernel made, kept so that its shares can be compared.
    Then the Schur factors, two in-place Gauss-Jordans (2 m³), and the
    products Rx Dx⁻¹ and Rx Dx⁻¹ Dy1; a structured solve ≈ 1.55k; a
    candidate one residual, its step and its merit. Bytes are every input
    and every output once, the model's constants as ``CONSTANTS_SIZE``."""
    kernel = QUADRUPED
    nx, ny, ne, nz = 11, 16, 27, kernel.nz
    residual = RESIDUAL
    gauss_jordan = lambda m: 2 * m * m * m
    factor = (JACOBIAN[jacobian] + gauss_jordan(nx) + 2 * ny * nx * nx
              + 2 * ny * ny * nx + ny * ny + 2 * ny)
    solve = 2 * (ny * nx + ny * ny + nx * ny + nx * nx) + 6 * ny
    apply_reg = 2 * ne * ne + ny + 3 * ny
    refined = solve + refine * (apply_reg + solve + 2 * nz)
    steps = 3 * 3 * 2 * ny + 2 * 4 * ny + 4 * nz   # step lengths, μ, rhs
    candidate = residual + 2 * nz + 3 * ny + 2 * nz + 4
    trip = (factor + 3 * refined + steps
            + 2 * (max_ls + 1) * candidate + 2 * nz + 3 * ny)
    per_problem = 400 + residual + 3 * ny     # θ's terms, the first residual
    flops = n * per_problem + trips * trip
    nbytes = (8 * CONSTANTS_SIZE
              + elem_bytes * (n * (nz + kernel.nt) + n * (nz + 2))
              + n * (4 + 1))
    return flops, nbytes


# NVIDIA H100 SXM, published peaks: outside the tensor cores by the
# tensors' bytes a value (float32, float64), and HBM3
PEAK_FLOPS = {4: 67e12, 8: 34e12}
PEAK_BYTES = 3.35e12


def bound_ms(n: int, trips: int, opts: IPOptions, elem_bytes: int,
             jacobian: str = "closed_form"):
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    one call, the larger of ``work``'s operations over the card's rate for
    the tensors' type and its bytes over the card's memory rate, and which.
    The function asked for on float32 tensors is a float32 solve, so its
    rate is float32's whatever the kernel computes in. ``jacobian`` as
    ``work`` takes it."""
    flops, nbytes = work(n, trips, opts.max_ls, opts.refine, elem_bytes,
                         jacobian)
    by = {"operations": 1e3 * flops / PEAK_FLOPS[elem_bytes],
          "bytes": 1e3 * nbytes / PEAK_BYTES}
    which = max(by, key=by.get)
    return by[which], which
