"""The sim step's interior-point solve as replayed CUDA graphs.

The port's counterpart of the compiled sim solve of the JAX package, whose
``ip_solve`` is one program under ``jax.jit`` (a ``fori_loop`` of fixed
iterations or a ``while_loop``, ``contactimplicitmpc_tpu/sim/
interior_point.py``). PyTorch dispatches each op of a loop trip from
Python, ≈ 1.2k small kernels a trip on the quadruped; a CUDA graph captures
them once and a replay launches them all with one call.

``SimSolve(model, env, opts)`` is the solve ``simulate`` and
``mpc_rollout`` call each sim step, ``solve(z0, θ) -> IPResult``; each
caller makes its own once a rollout. On CPU tensors it is ``ip_solve``.
On CUDA tensors a model and terrain with a hand-written kernel
(``ops.sim_ip.KERNELS``: today the quadruped on flat ground) take it, the
whole solve in one launch; every other model or terrain keeps, for each (batch shape, dtype, device) it meets, graphs of
``interior_point.ip_program`` over static buffers for ``z0`` and ``θ``:

* fixed iterations (``opts.fixed_iters > 0``, the ``fori_loop``): one graph
  of the whole solve, cold restarts and divergence guard included,
  replayed once a step, with no read from the device;
* adaptive (the ``while_loop``): a graph of ``start``, one of a loop
  ``trip``, one of ``restart`` where ``opts.retries`` asks for it, and one
  of ``finish``; ``start``, ``trip`` and ``restart`` also write whether a
  problem is still live. ``trip`` is replayed while one is, with one read
  of that flag a trip, as the eager loop reads it. One trip a replay: a
  replayed trip costs its device time, milliseconds at these shapes,
  against tens of microseconds for the read, so k trips between reads
  would save little and spend up to k − 1 trips of device work past the
  last live problem.

A graph set is captured at its first call (``utils/cuda_graphs.py``'s
``Captured``): each piece runs once eagerly on a side stream (the models'
constants and the libraries' handles and workspaces are made there,
outside any capture), then is captured on that stream, the set's graphs
sharing one memory pool (they replay one after another on one stream, and
each output is copied out before the next replay). A capture that fails
raises: there is no eager path on the card. The outputs are copied out of
the graphs' buffers before the call returns.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..dims import Dims
from ..models.base import Model, dims_of
from ..ops import sim_ip
from ..utils.cuda_graphs import Captured
from .interior_point import (IPOptions, IPResult, IPState, ip_program,
                             ip_solve, run_program)
from .residual import residual


# What the sim solves of this process did on the card, summed, for the
# smoke test and the span tool to reset and read (plain numbers, as the
# knot kernel's launch count): solves replayed, graph sets captured, and
# those captures' warm-up and capture seconds and device bytes.
stats = dict.fromkeys(("replays", "sets", "warmup_s", "capture_s",
                       "pool_bytes"), 0)


def reset_stats():
    for key in stats:
        stats[key] = 0


class _GraphSet:
    """The captured graphs of one (batch shape, dtype, device)."""

    def __init__(self, dims, residual_fn, opts, cone, z0, theta):
        self.opts = opts
        self.z0 = z0.clone()             # static inputs
        self.theta = theta.clone()
        prog = ip_program(dims, residual_fn, self.z0, self.theta, opts,
                          cone=cone)
        self.fixed = opts.fixed_iters > 0
        if not self.fixed:
            # the adaptive loop's carry and live flag, made on the caller's
            # stream outside the graphs' pool
            self.state = IPState(*(x.clone() for x in prog.start(self.z0)))
            self.flag = torch.zeros((), dtype=torch.bool, device=z0.device)

            def store(new):
                for dst, src in zip(self.state, new):
                    dst.copy_(src)
                self.flag.copy_(prog.live(new).any())

            pieces = {"start": lambda: store(prog.start(self.z0)),
                      "trip": lambda: store(prog.trip(self.state)),
                      "finish": lambda: prog.finish(self.state)}
            if opts.retries:
                pieces["restart"] = lambda: store(prog.restart(self.state))
        else:
            pieces = {"solve": lambda: run_program(prog, self.z0, opts)}

        def warmup():
            # each piece once (a fixed solve through one trip, not all of
            # its trips)
            if self.fixed:
                s = prog.trip(prog.start(self.z0))
                prog.finish(prog.restart(s) if opts.retries else s)
            else:
                for fn in pieces.values():
                    fn()

        # the graphs read tensors the program made outside them (its
        # constants): the set keeps the program, and so them, alive. It
        # keeps no piece: they refer to the set, and a cycle would leave a
        # dead set's graphs to the cyclic collector, which may run inside
        # another capture
        self.prog = prog
        self.graphs = Captured(pieces, warmup, z0.device, stats)

    def __call__(self, z0, theta) -> IPResult:
        stats["replays"] += 1
        self.z0.copy_(z0)
        self.theta.copy_(theta)
        if self.fixed:
            out = self.graphs.replay("solve")
        else:
            self.graphs.replay("start")
            for attempt in range(self.opts.retries + 1):
                if attempt:
                    self.graphs.replay("restart")
                while bool(self.flag):        # one read a trip
                    self.graphs.replay("trip")
            out = self.graphs.replay("finish")
        return IPResult(*(None if x is None else x.clone() for x in out))


def _residual_of(model, env):
    """The residual of ``model`` on ``env`` as a function of one sample; a
    closure over the two alone, so that a graph set, which keeps its
    program and so this function, refers to no ``SimSolve``."""
    def residual_fn(z, theta, kappa):
        return residual(model, env, z, theta, kappa)

    return residual_fn


class SimSolve:
    """The sim step's solve of ``model`` on ``env``, ``ip_solve(dims,
    residual, z0, θ, opts, cone=env.cone)``, by a route decided from the
    tensors' device, the model and the terrain, never from a failure
    (``route``): ``"eager"`` on CPU tensors; ``"kernel"`` on CUDA tensors
    for a model and terrain that ``ops.sim_ip.KERNELS`` lists (one launch a
    step, counted in ``sim_ip.launches``); ``"graphs"`` for every other
    model or terrain on CUDA tensors (the module's docstring;
    ``graph_sets`` holds the captured sets, ``stats`` counts their
    replays)."""

    def __init__(self, model: Model, env, opts: IPOptions):
        self.model, self.env, self.opts = model, env, opts
        self.dims: Dims = dims_of(model, env)
        self.cone = env.cone
        self.residual_fn: Callable = _residual_of(model, env)
        self.graph_sets = {}

    def route(self, z0) -> str:
        if not z0.is_cuda:
            return "eager"
        return "kernel" if sim_ip.takes(self.model, self.env) else "graphs"

    def __call__(self, z0, theta) -> IPResult:
        route = self.route(z0)
        if route == "eager":
            return self._eager(z0, theta)
        if route == "kernel":
            return self._kernel(z0, theta)
        return self._graphed(z0, theta)

    def _eager(self, z0, theta) -> IPResult:
        return ip_solve(self.dims, self.residual_fn, z0, theta, self.opts,
                        cone=self.cone)

    def _kernel(self, z0, theta) -> IPResult:
        return sim_ip.sim_ip(self.model, self.env, z0, theta, self.opts)

    def _graphed(self, z0, theta) -> IPResult:
        key = (tuple(z0.shape), tuple(theta.shape), z0.dtype, z0.device)
        graphs = self.graph_sets.get(key)
        if graphs is None:
            graphs = self.graph_sets[key] = _GraphSet(
                self.dims, self.residual_fn, self.opts, self.cone, z0, theta)
        return graphs(z0, theta)
