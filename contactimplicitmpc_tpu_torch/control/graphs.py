"""The MPC's Newton solve as replayed CUDA graphs.

The port's counterpart of the JAX package's jitted Newton loops: the
structure mode's masked ``fori_loop``/``while_loop``
(``contactimplicitmpc_tpu/control/structure_solver.py``) and the direct
mode's ``while_loop`` (``control/newton.py``) with its LDLᵀ's
``fori_loop`` (``ops/linsolve.py``). PyTorch dispatches each op of those
loops from Python; the KKT solves inside them are one launch each of a
hand-written kernel (``ops/structure_kkt.py``, ``ops/ldl.py``). A CUDA
graph captures them once and a replay launches them all with one call.

``NewtonSolve(dims, mode, obj, horizon, ip_opts, opts, newton_mode)`` is
made once a rollout (``mpc_rollout``) and once a policy
(``ci_mpc_policy``), and every Newton call of theirs goes through it:
``solve(lin, q_ref, u_ref, θ_template, q0, q1, state, alt)`` in structure
mode, ``solve(lin, ref, traj, ν, q0, q1, alt)`` in direct mode, the
arguments and results of ``structure_newton_solve`` and ``newton_solve``
less what the solve holds. Its route is decided from the tensors' device
and the options, never from a failure (``route``):

* ``"eager"`` on CPU tensors: ``structure_newton_solve`` /
  ``newton_solve`` as they are;
* ``"graphs"`` on CUDA tensors with fixed knot solves
  (``opts.fixed_ip_iters > 0``, the knot kernel). For each (shapes,
  dtypes, device) of its inputs it meets, a set of graphs over static
  input buffers, captured at its first call:

  - structure mode: one graph of the whole solve (its masked trips read
    nothing: the warm start's sanitizing, the first residual, and each
    trip's structured KKT solve, 7-trial line search and masked update),
    replayed once a call;
  - direct mode: a graph of ``start`` (the sanitizing, the pinning, the
    first implicit dynamics and residual) and one of a ``trip`` (the KKT's
    assembly, its LDLᵀ solve, the line search,
    the masked update), each writing whether a lane is still live;
    ``trip`` is replayed while one is, with one read of that flag a trip,
    as the eager loop reads it. With ``opts.fixed_newton_iters > 0`` one
    graph of the whole solve, with no read;

* ``"eager"`` on CUDA tensors for the adaptive knot solve
  (``opts.fixed_ip_iters == 0``): its ``ip_solve`` reads the device inside
  a trip, so it cannot be captured. Such a solve runs eagerly and counts
  in ``stats["eager"]``; no chip path takes it.

Before a replay the inputs that change between calls (the gathered
linearization window, the reference window or ``q_ref``, ``u_ref`` and
the θ template, the warm start, ``q0``, ``q1`` and the altitude) are
copied into the set's buffers. What the solve holds fixed (the objective,
the structure objective, the assembler and its index tensors, the
options) is read by the graphs as it is, and the set keeps it alive. The
outputs are cloned before the call returns. The capture is
``utils/cuda_graphs.py``'s: a warm-up of each piece on a side stream (the
assembler's index tensors and the libraries' workspaces are made there),
one memory pool a set, no cyclic collection during a capture, and the
launches a replay makes of the knot kernel and of the two KKT kernels
(``csrc/structure_kkt.cu`` a structure-mode trip, ``csrc/ldl.cu`` a
direct-mode trip) counted in ``knot_ip.launches``,
``structure_kkt.launches`` and ``ldl.launches``. A capture that fails
raises: there is no eager path for a solve the graphs take.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from ..dims import Dims
from ..ops.knot_ip import knot_ip
from ..ops.ldl import ldl
from ..ops.structure_kkt import structure_kkt
from ..sim.interior_point import IPOptions
from ..utils.cuda_graphs import Captured
from .newton import (NewtonAssembler, NewtonOptions, newton_program,
                     newton_solve, run_newton)
from .structure_solver import (structure_newton_solve,
                               structure_objective_from_tracking)

# What the Newton solves of this process did on the card, summed, for the
# smoke test and the span tool to reset and read: solves replayed, trip
# graphs replayed (direct mode), solves on CUDA tensors run eagerly (the
# adaptive knot solve), graph sets captured, their warm-up and capture
# seconds and device bytes, and the knot kernel's and the KKT kernels'
# launches their warm-ups made (real launches, in ``knot_ip.launches``,
# ``structure_kkt.launches`` and ``ldl.launches`` too).
stats = dict.fromkeys(("replays", "trips", "eager", "sets", "warmup_s",
                       "capture_s", "pool_bytes", "warmup_launches",
                       "warmup_kkt_launches"), 0)
# the wrappers whose launches the graphs count through their replays
COUNTERS = (knot_ip, structure_kkt, ldl)


def kkt_launches() -> int:
    """The two KKT kernels' launches, summed."""
    return structure_kkt.launches + ldl.launches


def reset_stats():
    for key in stats:
        stats[key] = 0


class _GraphSet:
    """The captured graphs of one (input shapes, dtypes, device)."""

    def __init__(self, solve: "NewtonSolve", args):
        leaves, spec = tree_flatten(args)
        self.inputs = [x.clone() for x in leaves]   # static inputs
        static = tree_unflatten(self.inputs, spec)
        opts = solve.opts
        # the graphs read what the solve holds fixed: the set keeps it
        # alive, and keeps no piece (they refer to the set, and a cycle
        # would leave a dead set's graphs to the cyclic collector)
        self.consts = (solve.obj, solve.sobj, solve.assembler)
        self.loop = not solve.structure and opts.fixed_newton_iters <= 0
        self.prog = None
        launched, kkt_launched = knot_ip.launches, kkt_launches()
        if solve.structure:
            def whole():
                return structure_newton_solve(
                    solve.dims, solve.sobj, *static, solve.ip_opts, opts,
                    solve.horizon)

            pieces, warmup = {"solve": whole}, whole
        else:
            # the program's constants (α, the lane index, the trials'
            # altitude view) are read by the graphs: the set keeps it
            prog = self.prog = newton_program(
                solve.dims, solve.mode, solve.assembler, solve.obj, *static,
                solve.ip_opts, opts)
            if self.loop:
                # the loop's carry and live flag, made on the caller's
                # stream outside the graphs' pool
                self.state = tree_map(torch.clone, prog.start())
                self.flag = torch.zeros((), dtype=torch.bool,
                                        device=leaves[0].device)

                def store(new):
                    for dst, src in zip(tree_leaves(self.state),
                                        tree_leaves(new)):
                        dst.copy_(src)
                    self.flag.copy_(prog.live(new).any())

                pieces = {"start": lambda: store(prog.start()),
                          "trip": lambda: store(prog.trip(self.state))}

                def warmup():
                    for fn in pieces.values():
                        fn()
            else:
                pieces = {"solve": lambda: run_newton(prog, opts)}

                def warmup():       # one trip, not all of them
                    prog.finish(prog.trip(prog.start()))

        self.graphs = Captured(pieces, warmup, leaves[0].device, stats,
                               counters=COUNTERS)
        stats["warmup_launches"] += knot_ip.launches - launched
        stats["warmup_kkt_launches"] += kkt_launches() - kkt_launched

    def __call__(self, args):
        stats["replays"] += 1
        for dst, src in zip(self.inputs, tree_leaves(args)):
            dst.copy_(src)
        if not self.loop:
            out = self.graphs.replay("solve")
        else:
            self.graphs.replay("start")
            while bool(self.flag):            # one read a trip
                self.graphs.replay("trip")
                stats["trips"] += 1
            out = self.prog.finish(self.state)
        return tree_map(torch.clone, out)


class NewtonSolve:
    """The MPC's Newton solve of one rollout or policy (the module's
    docstring): ``newton_mode`` ``"structure"`` or ``"direct"``, decision
    ``mode`` (direct mode), objective ``obj``, ``horizon`` knots, the knot
    solves' ``ip_opts`` and the Newton ``opts``. ``graph_sets`` holds the
    captured sets, ``stats`` counts their replays."""

    def __init__(self, dims: Dims, mode: str, obj, horizon: int,
                 ip_opts: IPOptions, opts: NewtonOptions,
                 newton_mode: str = "direct"):
        if newton_mode not in ("direct", "structure"):
            raise ValueError(f"invalid newton_mode {newton_mode!r}")
        self.dims, self.mode, self.obj = dims, mode, obj
        self.horizon, self.ip_opts, self.opts = horizon, ip_opts, opts
        self.newton_mode = newton_mode
        self.structure = newton_mode == "structure"
        self.sobj = (structure_objective_from_tracking(
            dims, obj, opts.beta_init, horizon) if self.structure else None)
        self.assembler = (None if self.structure
                          else NewtonAssembler(dims, horizon, mode))
        self.graph_sets = {}

    def route(self, like) -> str:
        """``"graphs"`` for CUDA tensors ``like`` with fixed knot solves,
        ``"eager"`` otherwise."""
        if like.is_cuda and self.opts.fixed_ip_iters > 0:
            return "graphs"
        return "eager"

    def __call__(self, *args):
        alt = args[-1]
        if self.route(alt) == "graphs":
            return self._graphed(*args)
        if alt.is_cuda:
            stats["eager"] += 1
        return self._eager(*args)

    def _eager(self, *args):
        if self.structure:
            return structure_newton_solve(self.dims, self.sobj, *args,
                                          self.ip_opts, self.opts,
                                          self.horizon)
        return newton_solve(self.dims, self.mode, self.assembler, self.obj,
                            *args, self.ip_opts, self.opts)

    def _graphed(self, *args):
        leaves = tree_leaves(args)
        key = (tuple((tuple(x.shape), x.dtype) for x in leaves),
               leaves[0].device)
        graphs = self.graph_sets.get(key)
        if graphs is None:
            graphs = self.graph_sets[key] = _GraphSet(self, args)
        return graphs(args)
