"""The plain reference of one configuration's closed loop, step by step.

Built on the frozen copy in ``cimpc``: it never imports the program. From a
configuration's own settings it works out again what the program derives
in its set-up (the reference trajectory from the gait file, the
linearization about every gait knot, the objective) and then answers two
questions about the steps the program took:

* ``sim_step``: the sim step's contact NCP from the configurations and
  the control the program's step started from, solved to the reference
  simulator's own tolerances (ContactImplicitMPC.jl's simulator
  defaults, ``simulator.jl:24-32``): the configuration it ends in;
* ``closed_loop``: the MPC's control updates of whole lanes, from update
  0 on, each from the two configurations the lane observed, with the
  program's solver settings, each update warm-started from the
  reference's own solve of the one before by the program's warm-start
  rule (``WarmRule``): the warm starts are worked out again, not read.

``dtype`` is the arithmetic: float64 for the reference; a lower type for
the comparison's control (``lowp``). ``device`` is where it computes: the
plain code is the same on the CPU and the GPU.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .cimpc.control.implicit_dynamics import CONFIGURATION, nd_of
from .cimpc.control.linearized import gather, linearize_trajectory
from .cimpc.control.newton import NewtonAssembler, NewtonOptions, newton_solve
from .cimpc.control.structure_solver import (StructureState, shift_state,
                                             state_from_reference,
                                             structure_newton_solve,
                                             structure_objective_from_tracking)
from .cimpc.control.trajectory import (ContactTraj, expand_traj, from_gait,
                                       get_stride, initial_conditions,
                                       update_theta, update_z)
from .cimpc.models.base import dims_of
from .cimpc.sim.interior_point import IPOptions, ip_solve, z_initialize
from .cimpc.sim.residual import pack_theta, residual

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
GAITS = os.path.join(ROOT, "contactimplicitmpc_tpu", "assets", "gaits")

# the reference simulator's defaults (simulator.jl:24-32)
SIM_TOLERANCES = dict(r_tol=1.0e-8, kappa_tol=1.0e-8, max_iter=100,
                      undercut=float("inf"), gamma_reg=0.0, max_ls=25)


def load_gait(name: str) -> dict:
    """A converted gait, ``<model>/<gait>``, read from its ``.npz`` file."""
    with np.load(os.path.join(GAITS, name + ".npz")) as f:
        return {k: f[k] for k in f.files}


class WarmRule(NamedTuple):
    """How the program's entry warm-starts a control update from the one
    before: ``full`` the previous plan shifted one knot (structure mode;
    else its duals alone, the primal stages from the reference), and a
    restart from the reference after an update whose Newton residual ends
    over ``reset_scale`` times its tolerance (0: never). The direct mode
    always takes the previous plan and duals."""

    full: bool = True
    reset_scale: float = 0.0


def ip_options(settings: dict) -> IPOptions:
    return IPOptions(**{k: float(v) if isinstance(v, str) else v
                        for k, v in settings.items()})


class ReferenceMPC:
    """The closed loop of ``model`` on ``env`` tracking ``gait`` under the
    configuration's MPC settings (``config["mpc"]``), in ``dtype``."""

    def __init__(self, model, env, config: dict, objective_fn,
                 dtype=torch.float64, device="cpu"):
        mpc = config["mpc"]
        self.model, self.env, self.dtype = model, env, dtype
        self.device = torch.device(device)
        self.dims = dims_of(model, env)
        self.h_mpc, self.n_sample = mpc["h_mpc"], mpc["n_sample"]
        self.kappa = mpc["kappa_mpc"]
        self.structure = mpc["newton_mode"] == "structure"
        if mpc["mode"] != CONFIGURATION:
            raise ValueError("the reference runs the configuration mode")
        self.ref = from_gait(model, env, load_gait(config["gait"]),
                             update_friction=True, dtype=dtype,
                             device=self.device)
        self.h_sim = float(self.ref.h) / self.n_sample
        self.obj = objective_fn(self.dims, self.h_mpc, dtype, self.device)
        self.n_opts = NewtonOptions(**mpc["newton"])
        self.ip_opts = ip_options(mpc["knot_ip"])
        self.sim_opts = IPOptions(**SIM_TOLERANCES)
        self.stride = get_stride(model, self.ref, (0,))
        self._lin = None

    @property
    def lin(self):
        """The linearization about every gait knot, made at first use."""
        if self._lin is None:
            # on the host, whatever the device: some thousand small
            # derivative operations, which the host runs sooner than it
            # launches them
            cpu = lambda tup: type(tup)(*(x.cpu() for x in tup))
            lin = linearize_trajectory(self.model, self.env, cpu(self.ref),
                                       self.kappa)
            self._lin = type(lin)(*(x.to(self.device) for x in lin))
            if self.structure:
                self.sobj = structure_objective_from_tracking(
                    self.dims, self.obj, self.n_opts.beta_init, self.h_mpc)
            else:
                self.assembler = NewtonAssembler(self.dims, self.h_mpc,
                                                 CONFIGURATION)
        return self._lin

    @property
    def newton_size(self) -> int:
        """The count of residual entries the Newton's tolerance is per."""
        d, h = self.dims, self.h_mpc
        if self.structure:
            return (h - 1) * (d.nu + 4 * d.nq)
        self.lin
        return self.assembler.ind.ntot

    def newton_converged(self, r_norm):
        """Whether a Newton solve ending at residual ``r_norm`` reached its
        tolerance (``r_norm / n < r_tol``, both solvers' test)."""
        return r_norm / self.newton_size < self.n_opts.r_tol

    def gait_start(self):
        """The gait's own initial configuration and velocity, (nq,) each."""
        return initial_conditions(self.ref)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _theta(self, qa, qb, u):
        w = torch.zeros((qa.shape[0], self.dims.nw), dtype=self.dtype,
                        device=self.device)
        return pack_theta(qa, qb, u, w, self.model.mu_world, self.h_sim)

    def sim_step(self, qa, qb, u):
        """(q2, gamma, b, converged): the sim step from configurations
        ``qa``, ``qb`` under the per-step control ``u``, each (B, ·), with
        no disturbance."""
        qa, qb, u = (self._tensor(x) for x in (qa, qb, u))
        theta = self._theta(qa, qb, u)
        z0 = z_initialize(self.dims, qb, self.dtype, cone=self.env.cone)
        model, env = self.model, self.env
        res = ip_solve(self.dims,
                       lambda z, th, kappa: residual(model, env, z, th, kappa),
                       z0, theta, self.sim_opts, cone=env.cone)
        d = self.dims
        return (res.z[:, d.iq2], res.z[:, d.igamma1], res.z[:, d.ib1],
                res.converged)

    def momentum_residual(self, qa, qb, u, q2, gamma, b):
        """(B,): the largest entry of the dynamics rows of the sim step's
        NCP residual (simulation.jl:133-186) at the answer (q2, γ, b) of
        the step from ``qa``, ``qb`` under ``u``; those rows hold no
        complementarity, so no κ."""
        d = self.dims
        qa, qb, u, q2, gamma, b = (self._tensor(x)
                                   for x in (qa, qb, u, q2, gamma, b))
        theta = self._theta(qa, qb, u)
        rest = torch.zeros((q2.shape[0], d.nz - d.nq - d.nc - d.nb),
                           dtype=self.dtype, device=self.device)
        z = torch.cat([q2, gamma, b, rest], dim=-1)
        model, env = self.model, self.env
        rows = torch.func.vmap(
            lambda zz, th: residual(model, env, zz, th, 0.0)[:d.nq])(z, theta)
        return rows.abs().amax(dim=-1)

    def window(self, k: int) -> ContactTraj:
        """The reference window of update ``k``: rows [k, k + H) of the
        gait, advanced one period of strides at each wrap (rotate! and
        mpc_stride!, mpc_utils.jl:1-107, in closed form)."""
        ref, h_mpc, h_ref = self.ref, self.h_mpc, self.ref.horizon
        rows2 = k + np.arange(h_mpc + 2)
        jm2 = rows2 - 2
        dev = self.device
        wraps = torch.as_tensor(jm2 // h_ref, dtype=self.dtype, device=dev)
        q_wrap = (ref.q[torch.as_tensor(jm2 % h_ref + 2, device=dev)]
                  + wraps[:, None] * self.stride[None, :])
        q_head = ref.q[torch.as_tensor(np.clip(rows2, 0, 1), device=dev)]
        q = torch.where(torch.as_tensor(rows2 <= 1, device=dev)[:, None],
                        q_head, q_wrap)
        rows = torch.as_tensor((k + np.arange(h_mpc)) % h_ref, device=dev)
        win = ContactTraj(h=ref.h, kappa=ref.kappa, q=q, u=ref.u[rows],
                          w=ref.w[rows], gamma=ref.gamma[rows],
                          b=ref.b[rows], z=ref.z[rows],
                          theta=ref.theta[rows])
        return update_theta(self.dims, update_z(self.dims, win))

    def closed_loop(self, q_obs, rule: WarmRule):
        """(u, converged): the controls (B, K, nu) that updates 0 .. K-1 of
        B lanes send for a whole control period (before the division by
        N_sample), and whether each update's Newton reached its tolerance
        (B, K). ``q_obs`` (B, K, nq) holds the configuration each lane
        observed at each update; update 0 sees the gait's q[0] as its
        previous one (policy.jl:101-102) and starts from the reference,
        as every update does that ``rule`` restarts. No altitude
        update."""
        q_obs = self._tensor(q_obs)
        batch = q_obs.shape[0]
        q_prev = self.ref.q[0].expand(batch, -1)
        ok = torch.ones(batch, dtype=torch.bool, device=self.device)
        carry, us, conv = None, [], []
        for k in range(q_obs.shape[1]):
            warm = ok & (k > 0)
            u, carry, r_norm = self._update(k, q_prev, q_obs[:, k], carry,
                                            warm, rule)
            if rule.reset_scale > 0:
                ok = r_norm < (rule.reset_scale * self.n_opts.r_tol
                               * self.newton_size)
            us.append(u)
            conv.append(self.newton_converged(r_norm))
            q_prev = q_obs[:, k]
        return torch.stack(us, dim=1), torch.stack(conv, dim=1)

    def _update(self, k: int, q_prev, q_now, carry, warm, rule: WarmRule):
        """One update: (u, what the next update warm-starts from, the
        Newton's final residual)."""
        batch, h = q_now.shape[0], self.h_mpc
        win = self.window(k)
        knots = (k + np.arange(h)) % self.ref.horizon
        alt = torch.zeros((batch, self.dims.nc), dtype=self.dtype,
                          device=self.device)
        lin = self.lin
        pick = lambda a, b: torch.where(
            warm.view((-1,) + (1,) * (b.dim() - 1)), a, b)
        if self.structure:
            q_ref, u_ref = win.q[:h + 1], win.u[:h - 1]
            st_ref = state_from_reference(q_ref, u_ref, self.dims, h)
            st = StructureState(*(x.expand((batch,) + x.shape).clone()
                                  for x in st_ref))
            if carry is not None and rule.full:
                st = StructureState(*map(pick, shift_state(
                    carry, q_ref, u_ref, h), st))
            elif carry is not None:
                st = st._replace(nu1=pick(carry.nu1, st.nu1),
                                 nu2=pick(carry.nu2, st.nu2))
            res = structure_newton_solve(
                self.dims, self.sobj, gather(lin, knots[:h - 1]), q_ref,
                u_ref, win.theta[:h - 1], q_prev, q_now, st, alt,
                self.ip_opts, self.n_opts, h)
            return res.state.u[:, 1], res.state, res.r_norm
        nd = nd_of(self.dims, CONFIGURATION)
        traj0 = expand_traj(win, (batch,))
        nu0 = torch.zeros((batch, h, nd), dtype=self.dtype,
                          device=self.device)
        if carry is not None:
            traj0 = ContactTraj(win.h, win.kappa, *map(pick, carry[0][2:],
                                                       traj0[2:]))
            nu0 = pick(carry[1], nu0)
        res = newton_solve(self.dims, CONFIGURATION, self.assembler, self.obj,
                           gather(lin, knots), win, traj0, nu0, q_prev,
                           q_now, alt, self.ip_opts, self.n_opts)
        return res.traj.u[:, 0], (res.traj, res.nu), res.r_norm
