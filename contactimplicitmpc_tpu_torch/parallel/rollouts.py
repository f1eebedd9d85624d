"""Sharded Monte-Carlo rollouts: a sweep's lanes split over the ranks of a
mesh, its statistics reduced across them.

PyTorch counterpart of ``contactimplicitmpc_tpu/parallel/rollouts.py``
(the reference's serial robustness loops, ``examples/hopper/
monte_carlo.jl:78-91``). Every rank calls these functions with the whole
batch of initial states; each runs its contiguous slice of the lanes as
one batched rollout on its device, and the sweep statistics reduce with
one ``all_reduce`` of their sums, as the JAX package's ``psum`` reduces
them: only scalars cross ranks. The lanes' outputs stay on their rank (a
batch laid out over the mesh, ``distributed.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..sim.simulator import SimTrajectory, simulate


class RolloutStats(NamedTuple):
    """Global sweep statistics (SimulatorStatistics equivalent), 0-dim
    tensors (``mean_final_q`` (nq,)) on the lanes' device."""

    n_rollouts: torch.Tensor
    success_rate: torch.Tensor   # fraction of rollouts with all solves ok
    mean_iterations: torch.Tensor
    mean_final_q: torch.Tensor   # (nq,)


class MPCSweepStats(NamedTuple):
    """Closed-loop MPC sweep health over every rank's lanes (the batched
    analog of the reference's per-example report: examples/quadruped/
    flat.jl:71-79 and the thresholds of mpc_quadruped.jl:61-68); float32
    0-dim tensors on the lanes' device."""

    n_rollouts: torch.Tensor
    success_rate: torch.Tensor      # all sim solves converged
    q_err: torch.Tensor             # tracking errors, successful lanes only
    u_err: torch.Tensor
    gamma_err: torch.Tensor
    b_err: torch.Tensor
    mean_newton_iters: torch.Tensor
    mean_sim_iters: torch.Tensor
    mean_r_norm: torch.Tensor       # final Newton residual, successful lanes


def local_lanes(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of the batch ``x`` (B, ...): the lanes
    are laid out over the mesh's axes in order, the last fastest. Raises
    where B does not divide by the mesh's size."""
    n = mesh.size()
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} lanes do not divide over a mesh of "
                         f"{n} ranks")
    per = x.shape[0] // n
    index = int(np.ravel_multi_index(tuple(mesh.get_coordinate()),
                                     tuple(mesh.shape)))
    return x[index * per:(index + 1) * per]


def all_sum(sums: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``sums`` over every rank (the mesh spans the
    process group): one ``all_reduce``. Under gloo, CUDA sums are reduced
    through the host."""
    if sums.is_cuda and dist.get_backend() == "gloo":
        host = sums.cpu()
        dist.all_reduce(host)
        return host.to(sums.device)
    out = sums.clone()
    dist.all_reduce(out)
    return out


def monte_carlo_rollouts(model, env, horizon: int, h: float,
                         q1_batch, v1_batch, policy=None,
                         disturbances=None, opts=None) -> SimTrajectory:
    """Single-device batched rollouts: ``simulate`` of the lanes (B, nq)."""
    return simulate(model, env, horizon, h, q1_batch, v1_batch,
                    policy=policy, disturbances=disturbances, opts=opts)


def sharded_rollouts(mesh, model, env, horizon: int, h: float,
                     q1_batch, v1_batch, policy=None, disturbances=None,
                     opts=None) -> SimTrajectory:
    """Rollouts sharded over every mesh axis (pure data parallel): this
    rank's lanes of the batch, rolled on its device."""
    return simulate(model, env, horizon, h, local_lanes(mesh, q1_batch),
                    local_lanes(mesh, v1_batch), policy=policy,
                    disturbances=disturbances, opts=opts)


def sharded_rollout_stats(mesh, model, env, horizon: int, h: float,
                          q1_batch, v1_batch, policy=None,
                          disturbances=None, opts=None) -> RolloutStats:
    """Each rank rolls its slice of the batch, then the sweep statistics
    sum across the mesh: counts and mean iterations in float32, as the JAX
    package casts them, the final configurations in the lanes' dtype."""
    traj = sharded_rollouts(mesh, model, env, horizon, h, q1_batch,
                            v1_batch, policy, disturbances, opts)
    f32 = torch.float32
    ok = traj.converged.all(dim=1)
    counts = torch.stack([
        torch.tensor(float(ok.shape[0]), dtype=f32, device=ok.device),
        ok.to(f32).sum(), traj.iterations.to(f32).mean(dim=1).sum()])
    q_sum = traj.q[:, -1, :].sum(dim=0)
    wide = torch.promote_types(q_sum.dtype, f32)
    sums = all_sum(torch.cat([counts.to(wide), q_sum.to(wide)]))
    n, succ, iters = sums[:3].to(f32)
    return RolloutStats(n_rollouts=n, success_rate=succ / n,
                        mean_iterations=iters / n,
                        mean_final_q=sums[3:].to(q_sum.dtype) / n)


def make_sharded_mpc_rollouts(mesh, rollout_fn, ref, n_sample: int,
                              idx_shift=(0,)):
    """The mesh-sharded CIMPC Monte-Carlo sweep.

    Returns ``fn(q1_batch, v1_batch) -> (MPCRollout, MPCSweepStats)``:
    ``rollout_fn(q1s, v1s) -> MPCRollout`` is the port's batched
    closed-loop rollout (``control.rollout.mpc_rollout`` with its settings
    bound, e.g. ``hotpath.make_quadruped_rollout``'s ``rollout``). Each rank
    rolls its slice of the batch and returns its lanes; the statistics
    (success rate, tracking errors over the successful lanes, iteration
    counts) sum across the mesh in float32 and are the same on every rank.
    """
    from ..control.trajectory import tracking_errors

    def fn(q1_batch, v1_batch):
        traj = rollout_fn(local_lanes(mesh, q1_batch),
                          local_lanes(mesh, v1_batch))
        f32 = torch.float32
        ok = traj.sim_converged.all(dim=1)
        errs = tracking_errors(ref, traj.q, traj.u, traj.gamma, traj.b,
                               n_sample, idx_shift)

        # tracking errors are summed over SUCCESSFUL rollouts only: a
        # diverged lane's error is meaningless (success_rate counts it) and
        # would otherwise poison the batch means
        def ok_sum(x):
            return torch.where(ok, x.to(f32), 0.0).sum()

        sums = all_sum(torch.stack([
            torch.tensor(float(ok.shape[0]), dtype=f32, device=ok.device),
            ok.to(f32).sum(), *(ok_sum(e) for e in errs),
            traj.newton_iterations.to(f32).mean(dim=1).sum(),
            traj.sim_iterations.to(f32).mean(dim=1).sum(),
            ok_sum(traj.mpc_r_norm.mean(dim=1))]))
        n, n_ok = sums[0], torch.clamp(sums[1], min=1.0)
        stats = MPCSweepStats(
            n_rollouts=n, success_rate=sums[1] / n,
            q_err=sums[2] / n_ok, u_err=sums[3] / n_ok,
            gamma_err=sums[4] / n_ok, b_err=sums[5] / n_ok,
            mean_newton_iters=sums[6] / n, mean_sim_iters=sums[7] / n,
            mean_r_norm=sums[8] / n_ok)
        return traj, stats

    return fn


def sharded_mpc_rollouts(mesh, rollout_fn, ref, n_sample: int,
                         q1_batch, v1_batch, idx_shift=(0,)):
    """One-shot convenience wrapper around ``make_sharded_mpc_rollouts``."""
    return make_sharded_mpc_rollouts(mesh, rollout_fn, ref, n_sample,
                                     idx_shift)(q1_batch, v1_batch)
