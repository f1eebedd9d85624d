"""Times of the PyTorch port's knot interior-point kernel on one NVIDIA GPU,
alone or in turns with the kernel the port had first.

    python3 tools/torch_knot_ip_times.py
        [--old path/to/the/first/knot_ip.cu] [--lanes 16,112,1792]
    python3 tools/torch_knot_ip_times.py --model MODEL

Builds ``contactimplicitmpc_tpu_torch/csrc/knot_ip.cu``, prints what ptxas
says of it, and times it on the gait2 knots with CUDA events (the launches
queued behind a spin on the device, as ``chip_smoke.cuda_ms`` does) at
N = lanes × 9 stages problems (16 → 144 and 112 → 1008 are the main path's
two shapes, 1792 → 16128 a large batch). Whether the kernel is right is
``chip_smoke.py``'s and the tests' business, not this tool's.

``--old`` names a source with the one C interface the kernel had before
the per-knot prologue (``knot_ip_launch`` with 13 pointers and no
``pack``): the port's first kernel, one warp a problem, for example
``git show <its commit>:contactimplicitmpc_tpu_torch/csrc/knot_ip.cu``
written to a file. It is built beside the new one and the two are timed in
turns (old, new, new, old) in this one process on this one card. To compare
two sources of today's interface, run the tool from a copy of the tree for
each within one job on one card.

``--model MODEL`` times the instantiation of another model of
``chip_smoke.phase_case`` (hopper_2D, centroidal_quadruped, flamingo,
hopper_3D, pushbot, walledcartpole, particle_2D, particle,
centroidal_quadruped_wall) on the knots chip_smoke.py compares it on, with
that phase's options, at N = 16 × 1 × K, 16 × 7 × K and 64 × 7 × K (a
path's two shapes over its K knots and a large batch), with 0 iterations
(the prologue, the final factorization and the sensitivity solve alone)
and with the paths' 8.

Every line of times carries the card's name and power limit, and the
kernel's bound from ``ops/knot_ip.py::bound_ms``.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import cuda_ms, knot_problems, phase_case  # noqa: E402
from contactimplicitmpc_tpu_torch.control.linearized import \
    linearize_trajectory  # noqa: E402
from contactimplicitmpc_tpu_torch.control.trajectory import \
    from_gait  # noqa: E402
from contactimplicitmpc_tpu_torch.device import describe  # noqa: E402
from contactimplicitmpc_tpu_torch.env import flat_2d_lc  # noqa: E402
from contactimplicitmpc_tpu_torch.hotpath import HotPathConfig  # noqa: E402
from contactimplicitmpc_tpu_torch.models.base import dims_of  # noqa: E402
from contactimplicitmpc_tpu_torch.models.quadruped import \
    quadruped  # noqa: E402
from contactimplicitmpc_tpu_torch.ops import cuda_build  # noqa: E402
from contactimplicitmpc_tpu_torch.ops import knot_ip as knot_mod  # noqa: E402
from contactimplicitmpc_tpu_torch.utils.gaits import load_gait  # noqa: E402


def load_old(source):
    """The older kernel: built beside the new one, bound with the
    interface it had (13 pointers, 9 ints, 6 floats, the stream)."""
    lib = os.path.join(cuda_build.BUILD_DIR, "knot_ip_old.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                    source], check=True)
    fn = ctypes.CDLL(lib).knot_ip_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    return fn


def old_call(fn, dims, knots, alt, th, q2, opts, iters):
    lead = th.shape[:-1]
    nz, nt = dims.nz, dims.ntheta
    new = lambda *s, dtype=torch.float32: torch.empty(
        s, dtype=dtype, device=th.device)
    outs = (new(*lead, nz), new(*lead, dtype=torch.bool), new(*lead),
            new(*lead), new(*lead, nz, nt))
    ptrs = [ctypes.c_void_p(t.data_ptr())
            for t in (*knots, alt, th, q2, *outs)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(*ptrs, th.numel() // nt, knots[0].shape[0], dims.nx, dims.ny,
                 nt, dims.nc, iters, opts.refine, opts.max_ls, opts.r_tol,
                 opts.kappa_tol, opts.kappa_tol / opts.undercut,
                 opts.gamma_reg, opts.tau_min, opts.tau_max,
                 ctypes.c_void_p(stream))
        assert err == 0, err
        return outs
    return call


def model_times(args, tag):
    """Another instantiation on the knots of its kernel phase."""
    print("build:", knot_mod.build(verbose=True), flush=True)
    model, env, ref, kappa, opts, k = phase_case(args.model)
    dims = dims_of(model, env)
    lin = linearize_trajectory(model, env, ref, kappa)
    rng = np.random.default_rng(0)
    for lanes, trials in ((16, 1), (16, 7), (64, 7)):
        n = lanes * trials * k
        knots, alt, th, q2 = knot_problems(lin, ref, lanes, trials, k, rng,
                                           dims)
        for iters in (0, 8):
            ms = cuda_ms(lambda: knot_mod.knot_ip(dims, *knots, alt, th, q2,
                                                  opts, iters),
                         args.reps, spin=True)
            bound, which = knot_mod.bound_ms(dims, n, k, iters, opts)
            print(f"knot_ip {args.model} N={n} K={k} iters={iters}: "
                  f"{ms:.4f} ms, bound {bound:.5f} ms by {which} {tag}",
                  flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None)
    ap.add_argument("--lanes", default="16,112,1792")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--model", default="quadruped")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    tag = f"[{describe('cuda')}]"
    print(tag, flush=True)
    if args.model != "quadruped":
        return model_times(args, tag)
    print("build:", knot_mod.build(verbose=True), flush=True)
    old = load_old(args.old) if args.old else None

    cfg = HotPathConfig()
    opts, iters = cfg.mpc_ip_options(), cfg.fixed_ip_iters
    dims = dims_of(quadruped, flat_2d_lc)
    ref = from_gait(quadruped, flat_2d_lc, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=torch.float32, device="cuda")
    lin = linearize_trajectory(quadruped, flat_2d_lc, ref, cfg.kappa_mpc)
    stages = cfg.h_mpc - 1
    knots = [x[:stages].contiguous() for x in lin]
    rng = np.random.default_rng(0)

    def problems(lanes):
        return knot_problems(lin, ref, lanes, 1, stages, rng, dims)[1:]

    for lanes in map(int, args.lanes.split(",")):
        p = problems(lanes)
        n = lanes * stages
        bound, which = knot_mod.bound_ms(dims, n, stages, iters, opts)
        new_fn = lambda: knot_mod.knot_ip(dims, *knots, *p, opts, iters)
        if old is not None:
            old_fn = old_call(old, dims, knots, *p, opts, iters)
            o1 = cuda_ms(old_fn, args.reps, spin=True)
        n1 = cuda_ms(new_fn, args.reps, spin=True)
        new_ms = min(n1, cuda_ms(new_fn, args.reps, spin=True))
        line = f"knot_ip N={n}: new {new_ms:.4f} ms"
        if old is not None:
            old_ms = min(o1, cuda_ms(old_fn, args.reps, spin=True))
            line += f", old {old_ms:.4f} ms ({old_ms / new_ms:.2f}x)"
        print(line + f", bound {bound:.4f} ms by {which}, share "
              f"{bound / new_ms:.4f} {tag}", flush=True)
    pack_ms = cuda_ms(lambda: knot_mod.pack_knots(dims, *knots), args.reps,
                      spin=True)
    print(f"prologue alone (K={stages}): {pack_ms:.4f} ms {tag}", flush=True)


if __name__ == "__main__":
    main()
