"""Physics rollout: a loop of interior-point NCP solves over a batch of
lanes.

PyTorch counterpart of ``contactimplicitmpc_tpu/sim/simulator.py``
(simulator.jl:15-63). Every lane takes the same number of steps, so the
loop is a Python loop over time with all lanes in each tensor; solver
failures are recorded per step in ``converged`` instead of aborting, and
``status`` is the reference's early-exit condition over the whole rollout.

Policies and disturbances are ``(init_state, apply)`` pairs of plain
functions with explicit state (policy.jl:1-30, disturbances.jl:1-85).
``init_state(batch)`` makes the state for ``batch`` lanes;
``apply(state, obs)`` (a policy) or ``apply(state, q, t)`` (a disturbance)
returns the (B, ·) input and the next state. The step index ``t`` and the
sample-and-hold counters are Python integers, the same for every lane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import Model, dims_of
from ..utils.spans import span
from .graphs import SimSolve
from .interior_point import IPOptions, z_initialize
from .residual import pack_theta


class PolicyObs(NamedTuple):
    """Observation handed to a policy each sim step."""

    q0: torch.Tensor      # (B, nq) previous configuration
    q1: torch.Tensor      # (B, nq) current configuration
    gamma: torch.Tensor   # (B, nc) most recent contact impulses
    t: int                # sim step index (0-based)


class SimTrajectory(NamedTuple):
    """Rollout storage (RoboDojo ``Trajectory`` equivalent), leading axis
    the lanes."""

    q: torch.Tensor          # (B, T + 2, nq): q[0], q[1] initial; q[t+2] = step t
    u: torch.Tensor          # (B, T, nu)
    w: torch.Tensor          # (B, T, nw)
    gamma: torch.Tensor      # (B, T, nc)
    b: torch.Tensor          # (B, T, nb)
    z: torch.Tensor          # (B, T, nz)
    converged: torch.Tensor  # (B, T) bool
    iterations: torch.Tensor  # (B, T) int32


def default_sim_options() -> IPOptions:
    """simulator.jl:24-32 defaults (undercut=Inf, tol 1e-8, 25 line-search
    halvings). The simulation path evaluates the exact Jacobian — the γ_reg
    cone clamp exists only in the linearized MPC path — so gamma_reg stays
    0 here; a τ cap keeps iterates off the cone boundary at contact
    transitions."""
    return IPOptions(r_tol=1.0e-8, kappa_tol=1.0e-8, max_iter=100,
                     undercut=float("inf"), gamma_reg=0.0, max_ls=25)


# ---------------------------------------------------------------------------
# Policies (src/simulator/policy.jl)
# ---------------------------------------------------------------------------

def _bound(x, like):
    return torch.as_tensor(np.asarray(x), dtype=like.dtype,
                           device=like.device)


def control_saturation(u, u_lower, u_upper):
    """Elementwise control clamp (simulator.jl:68)."""
    return torch.minimum(torch.maximum(_bound(u_lower, u), u),
                         _bound(u_upper, u))


def saturated_policy(policy, u_lower, u_upper):
    """Wrap any ``(init, apply)`` policy with control saturation."""
    init, apply = policy

    def apply_sat(state, obs: PolicyObs):
        u, state = apply(state, obs)
        return control_saturation(u, u_lower, u_upper), state

    return init, apply_sat


def empty_policy(model: Model):
    """Zero control."""

    def init_state(batch):
        return ()

    def apply(state, obs: PolicyObs):
        return obs.q1.new_zeros((obs.q1.shape[0], model.nu)), state

    return init_state, apply


def _held(traj, n_sample: int):
    """Sample-and-hold playback of ``traj`` (T, n) / N_sample, the index
    advancing every ``n_sample`` calls (policy.jl:4-30); the state is the
    Python pair (idx, cnt)."""

    def init_state(batch):
        return (-1, n_sample)

    def value(state, like):
        idx, cnt = state
        if cnt == n_sample:
            idx, cnt = idx + 1, 0
        row = traj[min(max(idx, 0), traj.shape[0] - 1)] / n_sample
        return (row.to(dtype=like.dtype, device=like.device).expand(
            like.shape[0], -1), (idx, cnt + 1))

    return init_state, value


def open_loop_policy(u_traj, n_sample: int = 1, device=None):
    """Sample-and-hold open-loop policy (policy.jl:4-30): plays
    ``u_traj[idx] / N_sample`` to every lane, advancing ``idx`` every
    ``N_sample`` sim steps. ``u_traj`` (T, nu) is put on ``device``, by
    default the GPU (``device.default_device``)."""
    u_traj = torch.as_tensor(np.asarray(u_traj), device=resolve_device(device))
    init_state, value = _held(u_traj, n_sample)

    def apply(state, obs: PolicyObs):
        return value(state, obs.q1)

    return init_state, apply


# ---------------------------------------------------------------------------
# Disturbances (src/simulator/disturbances.jl)
# ---------------------------------------------------------------------------

def empty_disturbances(model: Model):
    def init_state(batch):
        return ()

    def apply(state, q, t):
        return q.new_zeros((q.shape[0], model.nw)), state

    return init_state, apply


def open_loop_disturbances(w_traj, n_sample: int = 1, device=None):
    """disturbances.jl:4-35 — scaled by 1/N_sample with hold counters."""
    w_traj = torch.as_tensor(np.asarray(w_traj), device=resolve_device(device))
    init_state, value = _held(w_traj, n_sample)

    def apply(state, q, t):
        return value(state, q)

    return init_state, apply


def impulse_disturbances(w_traj, idx, device=None):
    """disturbances.jl:40-56 — impulse w_traj[i] applied at step idx[i]
    (0-based), to every lane."""
    w_traj = torch.as_tensor(np.asarray(w_traj), device=resolve_device(device))
    steps = [int(i) for i in np.asarray(idx).reshape(-1)]

    def init_state(batch):
        return ()

    def apply(state, q, t):
        w = q.new_zeros((w_traj.shape[1],))
        for i, step in enumerate(steps):
            if step == t:
                w = w + w_traj[i].to(q.dtype)
        return w.expand(q.shape[0], -1), state

    return init_state, apply


def random_disturbances(generator, model: Model, w_amp, horizon: int,
                        device=None, draw=None):
    """disturbances.jl:63-84 — uniform [0, w_amp) per step, made once and
    played to every lane. The uniform [0, 1) numbers are ``draw``
    (horizon, nw) where given, else drawn from ``generator`` (a
    ``torch.Generator`` of ``device``, or None for the default one)."""
    device = resolve_device(device)
    if draw is None:
        draw = torch.rand((horizon, model.nw), generator=generator,
                          device=device)
    else:
        draw = torch.as_tensor(np.array(draw), device=device)
    w = draw * torch.as_tensor(np.broadcast_to(np.asarray(
        w_amp, dtype=np.float64), (model.nw,)).copy(), dtype=draw.dtype,
        device=device)

    def init_state(batch):
        return ()

    def apply(state, q, t):
        row = w[min(max(t, 0), horizon - 1)].to(q.dtype)
        return row.expand(q.shape[0], -1), state

    return init_state, apply


# ---------------------------------------------------------------------------
# Rollout
# ---------------------------------------------------------------------------

def simulate(model: Model, env, horizon: int, h: float, q1, v1, policy=None,
             disturbances=None, friction: Optional[float] = None,
             opts: Optional[IPOptions] = None,
             live_plotter=None) -> SimTrajectory:
    """Roll the physics forward ``horizon`` steps from the lanes
    ``(q1, v1)``, each (B, nq), on the device of ``q1``.

    Equivalent of ``simulator(...)`` + ``simulate!(sim, q1, v1)``
    (simulator.jl:15-63). ``q0 = q1 − h v1`` seeds the two-configuration
    state of the variational integrator. Each step's interior-point solve
    is ``graphs.SimSolve``'s: on the card one launch of the sim kernel for
    the quadruped on flat ground and replayed CUDA graphs for every other
    model or terrain, eager on the CPU.

    ``live_plotter`` (``utils.live.LivePlotter``) receives each step's
    ``(t, q2, u, gamma)`` of every lane (B, ·) and plots lane 0 — the
    ``CIMPCOptions.live_plotting`` debug loop of the reference
    (mpc_utils.jl:156-183); it costs one host copy a step.
    """
    if q1.dim() != 2:
        raise ValueError("simulate: q1 and v1 are (B, nq), one row a lane")
    dims = dims_of(model, env)
    opts = opts or default_sim_options()
    mu = model.mu_world if friction is None else friction
    policy_init, policy_apply = policy or empty_policy(model)
    dist_init, dist_apply = disturbances or empty_disturbances(model)

    dtype = q1.dtype
    batch = q1.shape[0]
    q0 = q1 - h * v1.to(dtype)

    solve = SimSolve(model, env, opts)
    qa, qb = q0, q1
    pstate, dstate = policy_init(batch), dist_init(batch)
    gamma = q1.new_zeros((batch, dims.nc))
    steps = []
    for t in range(horizon):
        u, pstate = policy_apply(pstate, PolicyObs(qa, qb, gamma, t))
        w, dstate = dist_apply(dstate, qb, t)
        theta = pack_theta(qa, qb, u, w, mu, h)
        z0 = z_initialize(dims, qb, cone=env.cone)
        with span("sim_ip", theta):
            res = solve(z0, theta)
        q2 = res.z[:, dims.iq2]
        gamma = res.z[:, dims.igamma1]
        if live_plotter is not None:
            live_plotter.record(t, q2, u, gamma)
        steps.append((q2, u, w, gamma, res.z[:, dims.ib1], res.z,
                      res.converged, res.iterations))
        qa, qb = qb, q2

    if steps:
        qs, us, ws, gammas, bs, zs, conv, iters = (
            torch.stack(x, dim=1) for x in zip(*steps))
    else:
        empty = lambda n, dt=dtype: q1.new_zeros((batch, 0, n), dtype=dt)
        qs, us, ws, gammas, bs, zs = (empty(n) for n in (
            dims.nq, dims.nu, dims.nw, dims.nc, dims.nb, dims.nz))
        conv = q1.new_zeros((batch, 0), dtype=torch.bool)
        iters = q1.new_zeros((batch, 0), dtype=torch.int32)
    return SimTrajectory(q=torch.cat([q0[:, None], q1[:, None], qs], dim=1),
                         u=us, w=ws, gamma=gammas, b=bs, z=zs,
                         converged=conv, iterations=iters)


def status(traj: SimTrajectory) -> torch.Tensor:
    """The reference's simulate! early-exit condition over the whole
    rollout, per lane (B,)."""
    return traj.converged.all(dim=-1)
