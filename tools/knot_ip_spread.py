"""How far two correct float32 knot solves part: the JAX package's
``linearized_ip_fixed`` against the port's plain version, on the CPU, on
the problems chip_smoke.py gives the kernel.

    JAX_PLATFORMS=cpu python tools/knot_ip_spread.py [MODEL]

MODEL is an instantiation chip_smoke.py compares (hopper_2d, the default;
quadruped; centroidal_quadruped; flamingo; hopper_3D; or one of the models
no path runs: pushbot, walledcartpole, particle_2D, particle,
centroidal_quadruped_wall). The knots are the gait's first K (K = 10; the
flamingo's 15 and the 3D hopper's 20, their paths' horizons: the
flamingo's gait_forward_36_4 with examples/flamingo_slope.py's knot options,
the 3D hopper's gait_forward with tests/test_mpc_hopper_3d.py's; the
centroidal quadruped's in-place trot on flat_3d_lc with
examples/centroidal_trot.py's float32 knot options), or for the models no
path runs the K committed knot states of ``chip_smoke.PATHLESS``
(assets/knot_states.npz) with their κ; each linearized by the JAX package
in float32 and handed to both solvers. θ is perturbed by 0.003·N(0, 1)
from numpy.random.default_rng(0) for 16 lanes × 7 trials × K knots
problems. Prints one JSON line for 1, 3 and 8 iterations: the largest |Δz|
and relative |Δdz| over all problems, and the shares of problems that
agree within chip_smoke.py's bounds, among the problems both solves flag
as converged and among all (at an r_tol of 1e-8 no float32 solve is
flagged converged); and, under ``kernel_form``, the same shares of the
plain version against itself with the line search's equality rows in the
kernel's form (``affine_merit``, r − α Rza d): a third correct solver,
which parts from the plain version where the residual sits at its float32
floor through all iterations (the flamingo's knots at r_tol 1e-8).
chip_smoke.py's tolerances for the kernel against the plain version sit
under the smaller of the two.
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
from contactimplicitmpc_tpu.control.trajectory import \
    ContactTraj  # noqa: E402
from contactimplicitmpc_tpu.models import (MODELS,  # noqa: E402
                                           centroidal_quadruped, flamingo,
                                           hopper_2d, hopper_3d, quadruped)
from contactimplicitmpc_tpu.sim.interior_point import IPOptions  # noqa: E402
from contactimplicitmpc_tpu.ops.fixed_ip import \
    linearized_ip_fixed as jfixed  # noqa: E402
from contactimplicitmpc_tpu.utils.gaits import load_gait  # noqa: E402

import chip_smoke  # noqa: E402
from contactimplicitmpc_tpu_torch import interop  # noqa: E402
from contactimplicitmpc_tpu_torch.dims import Dims  # noqa: E402
from contactimplicitmpc_tpu_torch.ops.fixed_ip import \
    linearized_ip_fixed  # noqa: E402

LANES, TRIALS = 16, 7
Q2_TOL, Z_TOL, DZ_TOL = 1e-3, 5e-3, 1e-2


def spread(got, want, nq):
    """How far two solves of the same problems part: the largest |Δz| and
    relative |Δdz|, and the shares of problems within chip_smoke.py's
    bounds, among those both flag converged and among all."""
    conv_w = np.asarray(want.converged)
    conv_g = np.asarray(got.converged)
    both = conv_w & conv_g
    err = np.abs(np.asarray(got.z) - np.asarray(want.z))
    scale = np.maximum(np.abs(np.asarray(want.dz)).max(axis=(-2, -1)), 1e-30)
    dz = np.abs(np.asarray(got.dz) - np.asarray(want.dz)).max(
        axis=(-2, -1)) / scale
    share = lambda x: float(np.mean(x)) if x.size else float("nan")
    return {
        "z_max_err": float(err.max()), "dz_max_rel": float(dz.max()),
        "conv_ref": float(conv_w.mean()), "conv": float(conv_g.mean()),
        "conv_agree": float((conv_w == conv_g).mean()),
        "q2_share": share(err[both][:, :nq].max(axis=1) < Q2_TOL),
        "z_share": share(err[both].max(axis=1) < Z_TOL),
        "dz_share": share(dz[both] < DZ_TOL),
        "q2_share_all": share(err[..., :nq].max(axis=-1) < Q2_TOL),
        "z_share_all": share(err.max(axis=-1) < Z_TOL),
        "dz_share_all": share(dz < DZ_TOL)}


def states_ref(name, h):
    """The committed knot states of a model no path runs, as the JAX
    package's ContactTraj in float32."""
    with np.load(chip_smoke.KNOT_STATES) as f:
        t = {k: jnp.asarray(f[f"{name}/{k}"], jnp.float32)
             for k in ContactTraj._fields if k not in ("h", "kappa")}
    return ContactTraj(h=jnp.float32(h), kappa=jnp.float32(0.0), **t)


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "hopper_2d"
    env, knots = ci.flat_2d_lc, 10
    pathless = {row[0]: row for row in chip_smoke.PATHLESS}
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
    elif name == "flamingo":
        model, kappa, knots = flamingo, 2.0e-4, 15
        ref = jfrom_gait(model, env, load_gait("flamingo", "gait_forward_36_4"),
                         dtype=jnp.float32)
        opts = interop.options(IPOptions, chip_smoke.flamingo_options(kappa)[0])
    elif name == "hopper_3D":
        env, model, kappa, knots = ci.flat_3d_lc, hopper_3d, 1.0e-4, 20
        ref = jfrom_gait(model, env, load_gait("hopper_3D", "gait_forward"),
                         kappa=kappa, dtype=jnp.float32)
        opts = interop.options(IPOptions,
                               chip_smoke.hopper3d_knot_options(kappa))
    elif name in pathless:
        _, tenv, _, _, h, _, knots, kappa, _ = pathless[name]
        env = ci.flat_3d_lc if tenv.dim == 3 else ci.flat_2d_lc
        model = MODELS[name]
        ref = states_ref(name, h)
        opts = default_mpc_ip_options(kappa, max_iter=30)
    else:
        cfg = HotPathConfig()
        model, kappa = quadruped, cfg.kappa_mpc
        ref = jfrom_gait(model, env, load_gait("quadruped", "gait2"),
                         update_friction=True, dtype=jnp.float32)
        opts = cfg.mpc_ip_options()
    jd = ci.dims_of(model, env)
    lin = jlinearize(model, env, ref, kappa)
    lin = type(lin)(*(x[:knots] for x in lin))
    shape = (LANES, TRIALS, knots)
    noise = np.random.default_rng(0).standard_normal(shape + (jd.ntheta,))
    theta = (np.asarray(ref.theta[:knots]) + 0.003 * noise).astype(np.float32)
    q2 = np.broadcast_to(np.asarray(ref.q[2:knots + 2]),
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
        form = linearized_ip_fixed(dims, *tlin, torch.as_tensor(alt),
                                   torch.as_tensor(theta),
                                   torch.as_tensor(q2), topts, iters=iters,
                                   affine_merit=True)
        out[f"iters_{iters}"] = {
            **spread(got, want, jd.nq),
            "kernel_form": spread(form, got, jd.nq)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
