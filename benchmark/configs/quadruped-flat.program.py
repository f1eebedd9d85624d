"""``quadruped-flat`` as the program runs it: the port's shipped hot path
(``hotpath.make_quadruped_rollout``) for a sweep, ``ci_mpc_policy`` driving
``simulate`` for one robot under real-time control."""

import torch

from contactimplicitmpc_tpu_torch import hotpath
from contactimplicitmpc_tpu_torch.control.implicit_dynamics import \
    CONFIGURATION
from contactimplicitmpc_tpu_torch.control.policy import ci_mpc_policy
from contactimplicitmpc_tpu_torch.sim.simulator import simulate


def hot_path_config(config: dict) -> hotpath.HotPathConfig:
    mpc = config["mpc"]
    newton, knot, sim = mpc["newton"], mpc["knot_ip"], mpc["sim_ip"]
    return hotpath.HotPathConfig(
        h_mpc=mpc["h_mpc"], n_sample=mpc["n_sample"],
        kappa_mpc=mpc["kappa_mpc"], newton_mode=mpc["newton_mode"],
        newton_r_tol=newton["r_tol"], newton_iters=newton["max_iter"],
        newton_max_ls=newton["max_ls"],
        fixed_ip_iters=newton["fixed_ip_iters"],
        trial_ip_iters=newton["trial_ip_iters"],
        fixed_newton_iters=newton["fixed_newton_iters"],
        ls_growth_allow=newton["ls_growth_allow"],
        newton_reset_scale=mpc["newton_reset_scale"],
        mpc_r_tol=knot["r_tol"], mpc_ip_iters=knot["max_iter"],
        gamma_reg=knot["gamma_reg"], mpc_max_ls=knot["max_ls"],
        refine=knot["refine"], sim_r_tol=sim["r_tol"],
        sim_kappa_tol=sim["kappa_tol"], sim_iters=sim["max_iter"],
        sim_max_ls=sim["max_ls"], sim_refine=sim["refine"],
        sim_fixed_iters=sim["fixed_iters"], sim_retries=sim["retries"],
        warm_start_floor=mpc["warm_start_floor"],
        structure_full_warm=mpc["structure_full_warm"])


def rollout(config: dict, steps: int, device):
    """(rollout_fn(q1, v1) -> MPCRollout, gait reference) of ``steps`` sim
    steps for every lane of (B, nq) on ``device``."""
    cfg = hot_path_config(config)
    fn, ref, _, _, _ = hotpath.make_quadruped_rollout(
        cfg, steps, getattr(torch, config["dtype"]), device)
    return fn, ref


def policy(config: dict, device):
    """(policy, simulate_fn(q1, v1, steps, policy) -> SimTrajectory): the
    MPC policy, built once, and the physics that it drives."""
    cfg = hot_path_config(config)
    dtype = getattr(torch, config["dtype"])
    _, ref, model, env, dims = hotpath.make_quadruped_rollout(cfg, cfg.n_sample,
                                                              dtype, device)
    obj = hotpath.quadruped_tracking_weights(dims, cfg.h_mpc, dtype, device)
    pol = ci_mpc_policy(model, env, ref, obj, cfg.h_mpc, cfg.n_sample,
                        cfg.kappa_mpc, CONFIGURATION, cfg.newton_mode,
                        n_opts=cfg.newton_options(),
                        ip_opts=cfg.mpc_ip_options())
    h_sim = float(ref.h) / cfg.n_sample
    sim_opts = cfg.sim_ip_options()

    def run(q1, v1, steps, pol):
        return simulate(model, env, steps, h_sim, q1, v1, policy=pol,
                        opts=sim_opts)

    return pol, run
