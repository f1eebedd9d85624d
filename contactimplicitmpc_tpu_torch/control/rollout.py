"""Closed-loop MPC rollout over a batch of lanes.

PyTorch counterpart of ``contactimplicitmpc_tpu/control/rollout.py``::

    loop over control periods:
        one CIMPC Newton solve for every lane (direct or structure mode)
        loop over N_sample physics steps (interior-point sim)

Every lane runs the same period and step counts, so the loops are Python
loops over time with all lanes in each tensor. With fixed-iteration
solves (``sim_opts.fixed_iters``, ``n_opts.fixed_newton_iters`` or
structure mode) no value is read back to the host until the rollout
returns; the adaptive loops read one flag a trip. The sim steps' solves
are ``sim.graphs.SimSolve``'s: on the card one launch of the sim kernel
for the quadruped on flat ground, replayed CUDA graphs otherwise. The
Newton solves are ``control.graphs.NewtonSolve``'s: replayed CUDA graphs
on the card (with fixed knot solves), eager on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.base import Model, dims_of
from ..sim.graphs import SimSolve
from ..sim.interior_point import IPOptions, z_initialize
from ..sim.residual import pack_theta
from ..utils.spans import span
from .graphs import NewtonSolve
from .implicit_dynamics import (CONFIGURATION, default_mpc_ip_options,
                                nd_of)
from .linearized import gather, linearize_trajectory
from .newton import NewtonOptions
from .policy import CIMPCOptions
from .structure_solver import shift_state, state_from_reference
from .trajectory import (ContactTraj, expand_traj, get_stride, slice_horizon,
                         update_theta, update_z)


class MPCRollout(NamedTuple):
    """Per-lane outputs, leading axis B."""

    q: torch.Tensor                  # (B, T+2, nq)
    u: torch.Tensor                  # (B, T, nu) applied controls
    gamma: torch.Tensor              # (B, T, nc)
    b: torch.Tensor                  # (B, T, nb)
    sim_converged: torch.Tensor      # (B, T)
    mpc_r_norm: torch.Tensor         # (B, T/N_sample) final Newton residuals
    newton_iterations: torch.Tensor  # (B, T/N_sample)
    sim_iterations: torch.Tensor     # (B, T)
    sim_rvio: torch.Tensor           # (B, T) final equality-residual violation


def mpc_rollout(model: Model, env, ref_traj: ContactTraj, obj,
                horizon_sim: int, h_mpc: int, n_sample: int,
                kappa_mpc: float, mode: str, q1, v1,
                n_opts: Optional[NewtonOptions] = None,
                ip_opts: Optional[IPOptions] = None,
                sim_opts: Optional[IPOptions] = None,
                warm_start_floor: float = 0.0,
                newton_mode: str = "direct",
                mpc_opts=None, stride_idx=(0,),
                structure_full_warm: bool = True,
                w=None, sim_model: Optional[Model] = None, sim_env=None,
                newton_reset_scale: float = 0.0) -> MPCRollout:
    """Closed-loop CIMPC rollout of the lanes ``q1``, ``v1`` (B, nq); the
    reference, objective and options are shared. ``horizon_sim`` must be
    a multiple of ``n_sample``.

    ``newton_mode="direct"`` assembles the dense horizon KKT
    (``newton.py``); ``"structure"`` replaces it with the O(H)
    block-tridiagonal sweep (configuration mode; ``structure_solver.py``).
    ``w`` holds external disturbance forces per sim step, (T, nw) shared
    by the lanes or (B, T, nw). ``sim_model``/``sim_env`` let the physics
    run another model or terrain than the controller's."""
    structure = newton_mode == "structure"
    if not structure and newton_mode != "direct":
        raise ValueError(f"invalid newton_mode {newton_mode!r}")
    if structure and mode != CONFIGURATION:
        raise ValueError("structure-mode Newton runs in configuration mode")
    if horizon_sim % n_sample:
        raise ValueError("horizon_sim must be a multiple of n_sample")
    n_opts = n_opts or NewtonOptions(r_tol=3.0e-4, max_iter=5)
    ip_opts = ip_opts or default_mpc_ip_options(kappa_mpc)
    sim_opts = sim_opts or IPOptions(r_tol=1e-8, kappa_tol=1e-8,
                                     max_iter=100, undercut=float("inf"),
                                     max_ls=6)
    mpc_opts = mpc_opts or CIMPCOptions()
    n_ctrl = horizon_sim // n_sample
    dims = dims_of(model, env)
    dtype, device = ref_traj.q.dtype, ref_traj.q.device
    h_ref = ref_traj.horizon
    h_sim = float(ref_traj.h) / n_sample
    nq = dims.nq
    batch = q1.shape[0]

    lin = linearize_trajectory(model, env, ref_traj, kappa_mpc)
    stride = get_stride(model, ref_traj, stride_idx)
    newton = NewtonSolve(dims, mode, obj, h_mpc, ip_opts, n_opts,
                         newton_mode)
    nd = nd_of(dims, mode)

    def ref_window_at(t: int) -> ContactTraj:
        """Rows [t, t+h_mpc) of the receding-horizon reference — the closed
        form of t applications of rotate! + mpc_stride!
        (mpc_utils.jl:1-107): a gather plus a wrap-count stride offset."""
        rows2 = t + np.arange(h_mpc + 2)
        jm2 = rows2 - 2
        wraps = torch.as_tensor(jm2 // h_ref, dtype=dtype, device=device)
        q_wrap = (ref_traj.q[torch.as_tensor(jm2 % h_ref + 2, device=device)]
                  + wraps[:, None] * stride[None, :])
        q_head = ref_traj.q[torch.as_tensor(np.clip(rows2, 0, 1), device=device)]
        head = torch.as_tensor(rows2 <= 1, device=device)
        q = torch.where(head[:, None], q_head, q_wrap)
        rows = torch.as_tensor((t + np.arange(h_mpc)) % h_ref, device=device)
        win = ContactTraj(h=ref_traj.h, kappa=ref_traj.kappa, q=q,
                          u=ref_traj.u[rows], w=ref_traj.w[rows],
                          gamma=ref_traj.gamma[rows], b=ref_traj.b[rows],
                          z=ref_traj.z[rows], theta=ref_traj.theta[rows])
        # refresh the q-dependent slots of z and θ for the wrapped rows
        return update_theta(dims, update_z(dims, win))

    sim_model = sim_model or model
    sim_env = sim_env or env

    sim_solve = SimSolve(sim_model, sim_env, sim_opts)

    mu = model.mu_world
    # external disturbance forces per sim step, applied as given (zero if
    # absent): the OpenLoopDisturbance analog (disturbances.jl:40-60)
    if w is None:
        w_steps = torch.zeros((batch, horizon_sim, dims.nw), dtype=dtype,
                              device=device)
    else:
        w_steps = torch.as_tensor(w, dtype=dtype, device=device).expand(
            batch, horizon_sim, dims.nw)

    def sim_substeps(qa, qb, u, z_prev, w_period):
        """N_sample physics steps under the held control u / N_sample,
        warm-started from the previous step's cone variables floored away
        from the boundary (z_warmstart!-style, simulation.jl:87-101)."""
        u_step = u / n_sample
        outs = []
        for i in range(n_sample):
            theta = pack_theta(qa, qb, u_step, w_period[:, i], mu, h_sim)
            if warm_start_floor > 0:
                z0 = torch.cat([qb, torch.clamp(z_prev[:, nq:],
                                                min=warm_start_floor)], -1)
            else:
                z0 = z_initialize(dims, qb)
            with span("sim_ip", theta):
                res = sim_solve(z0, theta)
            q2 = res.z[:, :nq]
            # a DIVERGED solve must not seed the next step, but a merely
            # near-converged one (rvio within 100× tolerance) is a far
            # better seed than the cold initializer
            warm_ok = res.converged | (res.rvio < 100.0 * sim_opts.r_tol)
            z_prev = torch.where(warm_ok[:, None], res.z,
                                 z_initialize(dims, q2, dtype))
            outs.append((q2, res.z[:, dims.igamma1], res.z[:, dims.ib1],
                         res.converged, res.iterations, res.rvio))
            qa, qb = qb, q2
        return qa, qb, z_prev, [torch.stack(x, dim=1) for x in zip(*outs)]

    def update_altitude(alt, gamma_prev, q_prev, warm):
        """Terrain-height discovery from the last control period's contact
        impulses (update_altitude!, mpc_utils.jl:109-135)."""
        gamma_max, idx = torch.max(gamma_prev, dim=1)            # (B, nc)
        q_at = torch.gather(q_prev, 1, idx[..., None].expand(-1, -1, nq))
        phi = torch.func.vmap(torch.func.vmap(
            lambda q: model.phi(env, q)))(q_at)                   # (B, nc, nc)
        phi_i = torch.diagonal(phi, dim1=-2, dim2=-1)
        alt_new = torch.where(
            gamma_max > mpc_opts.altitude_impact_threshold, phi_i, alt)
        return torch.where(warm[:, None], alt_new, alt)

    # controller-level cold restart: a control solve that ends with its
    # residual far above tolerance resets the next period's warm start to
    # the reference (newton_reset_scale = 0 keeps the reference semantics)
    n_norm = ((h_mpc - 1) * (dims.nu + 4 * nq) if structure
              else newton.assembler.ind.ntot)
    fail_tol = newton_reset_scale * n_opts.r_tol * n_norm

    q1 = q1.to(dtype)
    q0 = q1 - h_sim * v1.to(dtype)
    if structure:
        warm_state = state_from_reference(ref_traj.q[:h_mpc + 1],
                                          ref_traj.u[:h_mpc - 1], dims, h_mpc)
        warm_state = type(warm_state)(*(x.expand((batch,) + x.shape).clone()
                                        for x in warm_state))
    else:
        warm_state = expand_traj(slice_horizon(ref_traj, h_mpc), (batch,))
        nu = torch.zeros((batch, h_mpc, nd), dtype=dtype, device=device)
    # the MPC's previous-control-period configuration starts at the gait's
    # q[0] (policy.jl:101-102)
    q_ctrl_prev = ref_traj.q[0].expand(batch, nq)
    qa_sim, qb_sim = q0, q1
    z_prev = z_initialize(dims, q1, dtype)
    alt = torch.zeros((batch, dims.nc), dtype=dtype, device=device)
    gamma_prev = torch.zeros((batch, n_sample, dims.nc), dtype=dtype,
                             device=device)
    q_prev = torch.zeros((batch, n_sample, nq), dtype=dtype, device=device)
    prev_ok = torch.ones((batch,), dtype=torch.bool, device=device)

    steps, us, r_norms, n_iters = [], [], [], []
    for t in range(n_ctrl):
        warm = prev_ok & (t > 0)
        if mpc_opts.altitude_update:
            alt = update_altitude(alt, gamma_prev, q_prev, warm)
        ref_window = ref_window_at(t)
        window = (t + np.arange(h_mpc)) % h_ref
        wm = lambda x: warm.view((-1,) + (1,) * (x.dim() - 1))
        if structure:
            lin_w = gather(lin, window[:h_mpc - 1])
            q_ref = ref_window.q[:h_mpc + 1]
            u_ref = ref_window.u[:h_mpc - 1]
            st_ref = state_from_reference(q_ref, u_ref, dims, h_mpc)
            if structure_full_warm:
                shifted = shift_state(warm_state, q_ref, u_ref, h_mpc)
                st0 = type(st_ref)(*(torch.where(wm(a), a, b)
                                     for a, b in zip(shifted, st_ref)))
            else:
                # duals-only warm start: primal stages from the reference
                st0 = type(st_ref)(
                    *(x.expand((batch,) + x.shape) for x in st_ref[:3]),
                    torch.where(wm(warm_state.nu1), warm_state.nu1,
                                st_ref.nu1),
                    torch.where(wm(warm_state.nu2), warm_state.nu2,
                                st_ref.nu2))
            with span("newton", qb_sim):
                result = newton(lin_w, q_ref, u_ref,
                                ref_window.theta[:h_mpc - 1], q_ctrl_prev,
                                qb_sim, st0, alt)
            u = result.state.u[:, 1]
            warm_state = result.state
        else:
            lin_w = gather(lin, window)
            traj0 = ContactTraj(ref_window.h, ref_window.kappa, *(
                torch.where(wm(a), a, b)
                for a, b in zip(warm_state[2:], ref_window[2:])))
            nu0 = torch.where(wm(nu), nu, torch.zeros_like(nu))
            # newton sees configurations one control period (= gait step
            # h) apart: (q at previous update, current q) — policy.jl:117-132
            with span("newton", qb_sim):
                result = newton(lin_w, ref_window, traj0, nu0, q_ctrl_prev,
                                qb_sim, alt)
            u = result.traj.u[:, 0]
            warm_state, nu = result.traj, result.nu

        q_ctrl_prev = qb_sim
        qa_sim, qb_sim, z_prev, ys = sim_substeps(
            qa_sim, qb_sim, u, z_prev,
            w_steps[:, t * n_sample:(t + 1) * n_sample])
        q_prev, gamma_prev = ys[0], ys[1]
        if newton_reset_scale > 0:
            prev_ok = result.r_norm < fail_tol
        steps.append(ys)
        us.append((u / n_sample)[:, None, :].expand(batch, n_sample, dims.nu))
        r_norms.append(result.r_norm)
        n_iters.append(result.iterations)

    qs, gammas, bs, conv, sim_iters, rvios = (torch.cat(x, dim=1)
                                              for x in zip(*steps))
    return MPCRollout(q=torch.cat([q0[:, None], q1[:, None], qs], dim=1),
                      u=torch.cat(us, dim=1), gamma=gammas, b=bs,
                      sim_converged=conv,
                      mpc_r_norm=torch.stack(r_norms, dim=1),
                      newton_iterations=torch.stack(n_iters, dim=1),
                      sim_iterations=sim_iters, sim_rvio=rvios)
