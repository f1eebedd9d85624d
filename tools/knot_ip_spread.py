"""How far two correct float32 knot solves part: the JAX package's
``linearized_ip_fixed`` against the port's plain version, on the CPU, on
the problems chip_smoke.py gives the kernel.

    JAX_PLATFORMS=cpu python tools/knot_ip_spread.py \
        [hopper_2d|quadruped|centroidal_quadruped]

The knots are the gait's first 10 (the centroidal quadruped's: its in-place
trot on flat_3d_lc, with examples/centroidal_trot.py's float32 knot
options), linearized by each package in float32;
θ is perturbed by 0.003·N(0, 1) from numpy.random.default_rng(0) for
16 lanes × 7 trials × 10 knots = 1120 problems. Prints one JSON line for
1, 3 and 8 iterations: the largest |Δz| and relative |Δdz| over all
problems, and the shares of problems that agree within chip_smoke.py's
bounds, among the problems both solves flag as converged and among all
(at the hopper's r_tol = 1e-8 no float32 solve is flagged converged). chip_smoke.py's tolerances for the kernel against the plain
version sit under these shares.
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contactimplicitmpc_tpu as ci  # noqa: E402
from contactimplicitmpc_tpu.control import from_gait as jfrom_gait  # noqa: E402
from contactimplicitmpc_tpu.control.implicit_dynamics import \
    default_mpc_ip_options  # noqa: E402
from contactimplicitmpc_tpu.control.linearized import \
    linearize_trajectory as jlinearize  # noqa: E402
from contactimplicitmpc_tpu.hotpath import HotPathConfig  # noqa: E402
from contactimplicitmpc_tpu.models import (centroidal_quadruped,  # noqa: E402
                                           hopper_2d, quadruped)
from contactimplicitmpc_tpu.sim.interior_point import IPOptions  # noqa: E402
from contactimplicitmpc_tpu.ops.fixed_ip import \
    linearized_ip_fixed as jfixed  # noqa: E402
from contactimplicitmpc_tpu.utils.gaits import load_gait  # noqa: E402

from contactimplicitmpc_tpu_torch import interop  # noqa: E402
from contactimplicitmpc_tpu_torch.dims import Dims  # noqa: E402
from contactimplicitmpc_tpu_torch.ops.fixed_ip import \
    linearized_ip_fixed  # noqa: E402

LANES, TRIALS, KNOTS = 16, 7, 10
Q2_TOL, Z_TOL, DZ_TOL = 1e-3, 5e-3, 1e-2


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "hopper_2d"
    env = ci.flat_2d_lc
    if name == "hopper_2d":
        model, kappa = hopper_2d, 1.0e-4
        ref = jfrom_gait(model, env, load_gait("hopper_2D", "gait_in_place"),
                         kappa=kappa, dtype=jnp.float32)
        opts = default_mpc_ip_options(kappa)
    elif name == "centroidal_quadruped":
        env, model, kappa = ci.flat_3d_lc, centroidal_quadruped, 2.0e-4
        ref = jfrom_gait(model, env,
                         load_gait("centroidal_quadruped", "inplace_trot_v2"),
                         update_friction=True, dtype=jnp.float32)
        opts = IPOptions(r_tol=1e-4, kappa_tol=kappa, max_iter=30,
                         undercut=5.0, gamma_reg=0.1, diff_sol=True,
                         max_ls=3, refine=1)
    else:
        cfg = HotPathConfig()
        model, kappa = quadruped, cfg.kappa_mpc
        ref = jfrom_gait(model, env, load_gait("quadruped", "gait2"),
                         update_friction=True, dtype=jnp.float32)
        opts = cfg.mpc_ip_options()
    jd = ci.dims_of(model, env)
    lin = jlinearize(model, env, ref, kappa)
    lin = type(lin)(*(x[:KNOTS] for x in lin))
    shape = (LANES, TRIALS, KNOTS)
    noise = np.random.default_rng(0).standard_normal(shape + (jd.ntheta,))
    theta = (np.asarray(ref.theta[:KNOTS]) + 0.003 * noise).astype(np.float32)
    q2 = np.broadcast_to(np.asarray(ref.q[2:KNOTS + 2]),
                         shape + (jd.nq,)).copy()
    alt = np.zeros(shape + (jd.nc,), np.float32)

    dims = Dims(nq=jd.nq, nu=jd.nu, nw=jd.nw, nc=jd.nc, nf=jd.nf, ne=jd.ne)
    tlin = interop.linearized_data(lin, dtype=torch.float32, device="cpu")
    topts = interop.ip_options(opts)
    out = {"model": name, "n": int(np.prod(shape))}
    for iters in (1, 3, 8):
        over_knots = jax.vmap(
            lambda z0, t0, r0, rz, rt, a, th, q: jfixed(
                jd, z0, t0, r0, rz, rt, a, th, q, opts, iters=iters))
        want = jax.jit(jax.vmap(jax.vmap(
            lambda a, th, q: over_knots(*lin, a, th, q))))(
                jnp.asarray(alt), jnp.asarray(theta), jnp.asarray(q2))
        got = linearized_ip_fixed(dims, *tlin, torch.as_tensor(alt),
                                  torch.as_tensor(theta), torch.as_tensor(q2),
                                  topts, iters=iters)
        conv_j = np.asarray(want.converged)
        conv_t = got.converged.numpy()
        both = conv_j & conv_t
        err = np.abs(got.z.numpy() - np.asarray(want.z))
        scale = np.maximum(np.abs(np.asarray(want.dz)).max(axis=(-2, -1)),
                           1e-30)
        dz = np.abs(got.dz.numpy() - np.asarray(want.dz)).max(
            axis=(-2, -1)) / scale
        share = lambda x: float(np.mean(x)) if x.size else float("nan")
        out[f"iters_{iters}"] = {
            "z_max_err": float(err.max()), "dz_max_rel": float(dz.max()),
            "conv_jax": float(conv_j.mean()), "conv_port": float(conv_t.mean()),
            "conv_agree": float((conv_j == conv_t).mean()),
            "q2_share": share(err[both][:, :jd.nq].max(axis=1) < Q2_TOL),
            "z_share": share(err[both].max(axis=1) < Z_TOL),
            "dz_share": share(dz[both] < DZ_TOL),
            "q2_share_all": share(err[..., :jd.nq].max(axis=-1) < Q2_TOL),
            "z_share_all": share(err.max(axis=-1) < Z_TOL),
            "dz_share_all": share(dz < DZ_TOL)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
