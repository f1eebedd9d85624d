"""Contact-implicit MPC policy.

PyTorch counterpart of ``contactimplicitmpc_tpu/control/policy.py``
(policy.jl, mpc_utils.jl): the policy is a pair of plain functions over an
explicit state, consumed by ``sim.simulator.simulate``.

Per control step (every ``N_sample`` sim steps, policy.jl:98-152):

1. optional altitude update from recent contact impulses
   (mpc_utils.jl:109-135)
2. warm-started Newton solve over the horizon against the rotating
   reference window, for every lane at once
3. receding-horizon shift of the reference (rot_n_stride!) and window
   advance
4. emit ``u[0] / N_sample``

The sample-and-hold counter and the sim step index are the same for every
lane, so they are Python integers and the branch on them a Python ``if``.
The rotating reference and the window are shared by the lanes too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.base import Model, dims_of
from ..sim.interior_point import IPOptions
from ..sim.simulator import PolicyObs
from ..utils.spans import span
from .graphs import NewtonSolve
from .implicit_dynamics import (CONFIGURATION_FORCE, default_mpc_ip_options,
                                nd_of)
from .linearized import gather, linearize_trajectory
from .newton import NewtonOptions
from .structure_solver import StructureState, shift_state, state_from_reference
from .trajectory import (ContactTraj, expand_traj, get_stride, rot_n_stride,
                         slice_horizon)


@dataclasses.dataclass(frozen=True)
class CIMPCOptions:
    """CIMPCOptions (policy.jl:5-14)."""

    altitude_update: bool = False
    altitude_impact_threshold: float = 1.0


class CIMPCState(NamedTuple):
    ref_traj: ContactTraj     # rotating reference (H_ref knots), shared
    newton_traj: ContactTraj  # warm-start working trajectory, (B, H_mpc, ·)
    nu: torch.Tensor          # (B, H_mpc, nd) dynamics duals
    window: np.ndarray        # (H_mpc,) gait-knot indices for lin data
    q0: torch.Tensor          # (B, nq) configuration at previous control step
    cnt: int                  # sample-and-hold counter
    u: torch.Tensor           # (B, nu) latest control (unscaled)
    altitude: torch.Tensor    # (B, nc)
    gamma_buf: torch.Tensor   # (B, N_sample, nc) recent contact impulses
    q_buf: torch.Tensor       # (B, N_sample, nq) matching configurations


class StructureCIMPCState(NamedTuple):
    """Structure-mode policy state: like CIMPCState but the warm start is
    the full previous ``StructureState`` (primal stages + duals)."""

    ref_traj: ContactTraj
    warm: StructureState      # leaves (B, ...)
    window: np.ndarray
    q0: torch.Tensor
    cnt: int
    u: torch.Tensor
    altitude: torch.Tensor
    gamma_buf: torch.Tensor
    q_buf: torch.Tensor


def ci_mpc_policy(model: Model, env, ref_traj: ContactTraj, obj, h_mpc: int,
                  n_sample: int = 1, kappa_mpc: float = 1.0e-4,
                  mode: str = CONFIGURATION_FORCE,
                  newton_mode: str = "direct",
                  n_opts: Optional[NewtonOptions] = None,
                  ip_opts: Optional[IPOptions] = None,
                  mpc_opts: CIMPCOptions = CIMPCOptions(),
                  stride_idx=(0,)):
    """Build the ``(init_state, apply)`` pair consumed by ``simulate``
    (ci_mpc_policy, policy.jl:42-96), on the device of ``ref_traj``.

    ``newton_mode``: ``"direct"`` assembles the dense horizon KKT;
    ``"structure"`` uses the O(H) block-tridiagonal sweep (configuration
    mode only).

    ``stride_idx``: configuration coordinates shifted by one gait period on
    each receding-horizon wrap (x only by default, mpc_utils.jl:103-107).
    """
    if newton_mode not in ("direct", "structure"):
        raise ValueError(f"invalid newton_mode {newton_mode!r}")
    structure = newton_mode == "structure"
    dims = dims_of(model, env)
    nd = nd_of(dims, mode)
    h_ref = ref_traj.horizon
    dtype, device = ref_traj.q.dtype, ref_traj.q.device

    n_opts = n_opts or NewtonOptions(r_tol=3.0e-4, max_iter=5)
    ip_opts = ip_opts or default_mpc_ip_options(kappa_mpc)

    # one-time linearization about every gait knot
    # (ImplicitTrajectory, implicit_dynamics.jl:21-90)
    lin = linearize_trajectory(model, env, ref_traj, kappa_mpc)
    stride = get_stride(model, ref_traj, stride_idx)
    # every control update's Newton solve: replayed CUDA graphs on the card
    newton = NewtonSolve(dims, mode, obj, h_mpc, ip_opts, n_opts,
                         newton_mode)

    def st_ref_of(ref_window):
        return state_from_reference(ref_window.q[:h_mpc + 1],
                                    ref_window.u[:h_mpc - 1], dims, h_mpc)

    def lanes(x, batch):
        return x.expand((batch,) + x.shape).clone()

    def init_state(batch: int):
        zeros = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype,
                                           device=device)
        common = dict(
            ref_traj=ref_traj, window=np.arange(h_mpc),
            q0=lanes(ref_traj.q[0], batch), cnt=n_sample,
            u=lanes(ref_traj.u[0], batch), altitude=zeros(dims.nc),
            gamma_buf=zeros(n_sample, dims.nc),
            q_buf=zeros(n_sample, dims.nq))
        ref_window = slice_horizon(ref_traj, h_mpc)
        if structure:
            return StructureCIMPCState(warm=StructureState(*(
                lanes(x, batch) for x in st_ref_of(ref_window))), **common)
        return CIMPCState(newton_traj=expand_traj(ref_window, (batch,)),
                          nu=zeros(h_mpc, nd), **common)

    def update_altitude(state):
        """mpc_utils.jl:109-135: per contact, take φ at the configuration
        of the recent step with the largest impulse, when it exceeds the
        threshold."""
        gamma_max, idx = torch.max(state.gamma_buf, dim=1)        # (B, nc)
        q_at = torch.gather(state.q_buf, 1,
                            idx[..., None].expand(-1, -1, dims.nq))
        phi = torch.func.vmap(torch.func.vmap(
            lambda q: model.phi(env, q)))(q_at)                    # (B, nc, nc)
        phi_i = torch.diagonal(phi, dim1=-2, dim2=-1)
        return torch.where(gamma_max > mpc_opts.altitude_impact_threshold,
                           phi_i, state.altitude)

    def control_update(state, obs: PolicyObs):
        warm = obs.t > 0
        batch = obs.q1.shape[0]
        alt = state.altitude
        if mpc_opts.altitude_update and warm:
            alt = update_altitude(state)
        ref_window = slice_horizon(state.ref_traj, h_mpc)

        if structure:
            lin_w = gather(lin, state.window[:h_mpc - 1])
            q_ref = ref_window.q[:h_mpc + 1]
            u_ref = ref_window.u[:h_mpc - 1]
            # full warm start: previous primal stages and duals when warm,
            # shifted one knot to stay aligned with the rotated window
            # (reset!/warm_start semantics, newton.jl:130-167)
            if warm:
                st0 = shift_state(state.warm, q_ref, u_ref, h_mpc)
            else:
                st0 = StructureState(*(lanes(x, batch)
                                       for x in st_ref_of(ref_window)))
            with span("newton", obs.q1):
                result = newton(lin_w, q_ref, u_ref,
                                ref_window.theta[:h_mpc - 1], state.q0,
                                obs.q1, st0, alt)
            solved = dict(warm=result.state, u=result.state.u[:, 1])
        else:
            lin_w = gather(lin, state.window)
            if warm:
                traj0, nu0 = state.newton_traj, state.nu
            else:
                traj0 = expand_traj(ref_window, (batch,))
                nu0 = torch.zeros_like(state.nu)
            with span("newton", obs.q1):
                result = newton(lin_w, ref_window, traj0, nu0, state.q0,
                                obs.q1, alt)
            solved = dict(newton_traj=result.traj, nu=result.nu,
                          u=result.traj.u[:, 0])

        return state._replace(
            ref_traj=rot_n_stride(dims, state.ref_traj, stride),
            window=(state.window + 1) % h_ref, q0=obs.q1, cnt=0,
            altitude=alt, **solved)

    def apply(state, obs: PolicyObs):
        # ring buffers of (γ, matching q) for the altitude update
        state = state._replace(
            gamma_buf=torch.cat([state.gamma_buf[:, 1:], obs.gamma[:, None]],
                                dim=1),
            q_buf=torch.cat([state.q_buf[:, 1:], obs.q1[:, None]], dim=1))
        if state.cnt == n_sample:
            with span("policy.update"):
                state = control_update(state, obs)
        state = state._replace(cnt=state.cnt + 1)
        return state.u / n_sample, state

    return init_state, apply
