"""Contact trajectories: the reference/working gait storage of the MPC.

PyTorch counterpart of ``contactimplicitmpc_tpu/control/trajectory.py``. A
``ContactTraj`` is a NamedTuple of stacked tensors whose leading axis is
the knot index; every update returns a new trajectory.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..dims import Dims
from ..models.base import Model, dims_of, e_mapping
from ..sim.residual import pack_theta, pack_z


class ContactTraj(NamedTuple):
    """trajectory.jl:1-19. Leading axis is the knot index."""

    h: torch.Tensor        # () time step
    kappa: torch.Tensor    # () central-path parameter
    q: torch.Tensor        # (H+2, nq)
    u: torch.Tensor        # (H, nu)
    w: torch.Tensor        # (H, nw)
    gamma: torch.Tensor    # (H, nc)
    b: torch.Tensor        # (H, nb)
    z: torch.Tensor        # (H, nz)
    theta: torch.Tensor    # (H, nθ)

    @property
    def horizon(self) -> int:
        return self.u.shape[-2]


def contact_trajectory(dims: Dims, horizon: int, h, kappa=0.0,
                       dtype=torch.float64, device=None) -> ContactTraj:
    """trajectory.jl:21-49 — zero-filled trajectory with the time step in
    θ, on ``device``, by default the GPU (``device.default_device``)."""
    device = resolve_device(device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    scalar = lambda x: torch.tensor(float(x), dtype=dtype, device=device)
    theta = zeros(horizon, dims.ntheta)
    theta[:, dims.ih] = float(h)
    return ContactTraj(h=scalar(h), kappa=scalar(kappa),
                       q=zeros(horizon + 2, dims.nq), u=zeros(horizon, dims.nu),
                       w=zeros(horizon, dims.nw), gamma=zeros(horizon, dims.nc),
                       b=zeros(horizon, dims.nb), z=zeros(horizon, dims.nz),
                       theta=theta)


def slice_horizon(traj: ContactTraj, horizon: int) -> ContactTraj:
    """The first ``horizon`` knots (copy_traj!, newton.jl:105-128)."""
    return ContactTraj(h=traj.h, kappa=traj.kappa,
                       q=traj.q[..., :horizon + 2, :],
                       u=traj.u[..., :horizon, :], w=traj.w[..., :horizon, :],
                       gamma=traj.gamma[..., :horizon, :],
                       b=traj.b[..., :horizon, :], z=traj.z[..., :horizon, :],
                       theta=traj.theta[..., :horizon, :])


def expand_traj(traj: ContactTraj, lead) -> ContactTraj:
    """``traj`` with its per-knot leaves broadcast to the leading shape
    ``lead`` (no copy); ``h`` and ``kappa`` stay scalars."""
    lead = tuple(lead)
    return ContactTraj(traj.h, traj.kappa, *(
        x.expand(lead + x.shape[-2:]) for x in traj[2:]))


def update_z(dims: Dims, traj: ContactTraj) -> ContactTraj:
    """trajectory.jl:51-65 — refresh the (q2, γ1, b1) slots of z."""
    z = torch.cat([traj.q[..., 2:, :], traj.gamma, traj.b,
                   traj.z[..., dims.ib1.stop:]], dim=-1)
    return traj._replace(z=z)


def update_theta(dims: Dims, traj: ContactTraj) -> ContactTraj:
    """trajectory.jl:67-82 — refresh the (q0, q1, u1, w1) slots of θ."""
    horizon = traj.horizon
    th = torch.cat([traj.q[..., :horizon, :], traj.q[..., 1:horizon + 1, :],
                    traj.u, traj.w, traj.theta[..., dims.iw1.stop:]], dim=-1)
    return traj._replace(theta=th)


def from_gait(model: Model, env, gait: dict, kappa=0.0,
              update_friction: bool = False, dtype=torch.float64,
              device=None) -> ContactTraj:
    """Build a ContactTraj from a converted gait asset
    (get_trajectory, trajectory.jl:143-185). ``update_friction`` replaces
    the gait's friction coefficient with the model's. The tensors lie on
    ``device``, by default the GPU (``device.default_device``)."""
    device = resolve_device(device)
    dims = dims_of(model, env)
    t = lambda k: torch.as_tensor(np.asarray(gait[k]), dtype=dtype,
                                  device=device)
    q, u, gam, b, psi, eta = (t(k) for k in ("q", "u", "gamma", "b", "psi",
                                             "eta"))
    h = float(np.asarray(gait["h"]))
    mu_file = float(np.asarray(gait["mu"]))
    mu = model.mu_world if (update_friction or np.isnan(mu_file)) else mu_file

    horizon = u.shape[0]
    w = torch.zeros((horizon, dims.nw), dtype=dtype, device=device)
    e = e_mapping(dims, dtype, device)

    # pack_z (index.jl:437-441): slacks from primals at the *model's* μ
    s1 = torch.func.vmap(lambda qq: model.phi(env, qq))(q[2:])
    s2 = model.mu_world * gam - b @ e.T
    z = pack_z(q[2:], gam, b, psi, s1, eta, s2)
    theta = pack_theta(q[:horizon], q[1:horizon + 1], u, w, mu, h)
    scalar = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return ContactTraj(h=scalar(h), kappa=scalar(kappa), q=q, u=u, w=w,
                       gamma=gam, b=b, z=z, theta=theta)


def repeat_traj(traj: ContactTraj, n: int, idx_shift=()) -> ContactTraj:
    """Tile a gait n times, shifting ``idx_shift`` coordinates by the gait
    stride each period (repeat_ref_traj, trajectory.jl:84-115)."""
    shift = torch.zeros_like(traj.q[-1])
    idx = list(idx_shift)
    if idx:
        shift[idx] = traj.q[-1, idx] - traj.q[1, idx]
    qs = [traj.q] + [traj.q[2:] + i * shift[None, :] for i in range(1, n)]
    tile = lambda x: torch.cat([x] * n, dim=0)
    return ContactTraj(h=traj.h, kappa=traj.kappa, q=torch.cat(qs, dim=0),
                       u=tile(traj.u), w=tile(traj.w), gamma=tile(traj.gamma),
                       b=tile(traj.b), z=tile(traj.z), theta=tile(traj.theta))


def get_stride(model: Model, traj: ContactTraj,
               stride_idx=(0,)) -> torch.Tensor:
    """mpc_utils.jl:103-107 — per-period offset of the gait in the
    coordinates ``stride_idx`` (x alone by default)."""
    idx = list(stride_idx)
    stride = torch.zeros_like(traj.q[0])
    stride[idx] = traj.q[-2, idx] - traj.q[0, idx]
    return stride


def rot_n_stride(dims: Dims, traj: ContactTraj, stride) -> ContactTraj:
    """Receding-horizon shift: rotate one knot and re-tile the wrap-around
    with the stride offset (rotate! + mpc_stride!, mpc_utils.jl:1-101)."""
    roll1 = lambda x: torch.roll(x, -1, dims=-2)
    q = roll1(traj.q)
    # mpc_stride!: last two configurations = first two + stride
    q = torch.cat([q[..., :-2, :], q[..., :2, :] + stride], dim=-2)
    out = ContactTraj(traj.h, traj.kappa, q, *map(roll1, traj[3:]))
    # refresh the q-dependent slots of z and θ
    return update_theta(dims, update_z(dims, out))


def initial_conditions(traj: ContactTraj):
    """trajectory.jl:219-224."""
    q1 = traj.q[1]
    v1 = (traj.q[1] - traj.q[0]) / traj.h
    return q1, v1


def tracking_errors(ref: ContactTraj, sim_q, sim_u, sim_gamma, sim_b,
                    n_sample: int, idx_shift=()):
    """Per-knot average L1 tracking errors against the tiled reference
    (trajectory.jl:188-217). The sim arrays may carry a leading batch axis;
    each error then has that shape."""
    h_sim = sim_u.shape[-2]
    h_ref = ref.horizon
    reps = int(np.ceil((h_sim / n_sample) / h_ref))
    dup = repeat_traj(ref, max(reps, 1), idx_shift=idx_shift)
    h_dup = dup.horizon

    nq, nu = ref.q.shape[1], ref.u.shape[1]
    nc, nb = ref.gamma.shape[1], ref.b.shape[1]
    # knots with a matching sim sample; the reference's loop counts one
    # extra iteration when it breaks mid-scan (trajectory.jl:196-205)
    t = np.arange(h_dup)
    tv = t[t * n_sample + 1 <= h_sim]
    cnt = min(tv.size + 1, h_dup)

    def l1(a, b_):
        return torch.sum(torch.abs(a - b_), dim=(-2, -1))

    q_err = l1(dup.q[tv + 2], sim_q[..., tv * n_sample + 2, :]) / nq
    u_err = l1(dup.u[tv], sim_u[..., tv * n_sample, :]) / nu
    g_err = l1(dup.gamma[tv], sim_gamma[..., tv * n_sample, :]) / nc
    b_err = l1(dup.b[tv], sim_b[..., tv * n_sample, :]) / nb
    return q_err / cnt, u_err / cnt, g_err / cnt, b_err / cnt


def tracking_error(ref: ContactTraj, sim_q, sim_u, sim_gamma, sim_b,
                   n_sample: int, idx_shift=()):
    """``tracking_errors`` of one rollout as Python floats."""
    return tuple(float(e) for e in tracking_errors(
        ref, sim_q, sim_u, sim_gamma, sim_b, n_sample, idx_shift))
