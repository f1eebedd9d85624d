"""The comparison catches a broken timed path: with the program broken
underneath and the rest of a run as it is (on the CPU, past the look for
a GPU), ``correct`` comes out false, once for each fault a cell can have.
A one-chip cell has no exchange between chips to leave out."""

import pytest
import torch

from benchmark.tests.tiny import tiny_cell, tiny_run
from contactimplicitmpc_tpu_torch.control import graphs as newton_graphs
from contactimplicitmpc_tpu_torch.parallel import rollouts
from contactimplicitmpc_tpu_torch.sim import graphs as sim_graphs

CELLS = ["quadruped-sweep", "centroidal-sweep", "quadruped-rt"]


def unchanged_state(monkeypatch):
    """A sim step that returns its state unchanged: q2 = q1, as converged."""
    solve = sim_graphs.SimSolve.__call__

    def broken(self, z0, theta):
        res = solve(self, z0, theta)
        return res._replace(z=z0.clone())
    monkeypatch.setattr(sim_graphs.SimSolve, "__call__", broken)


def altered_control(monkeypatch):
    """A control altered where the Newton solve produces it: 10% more."""
    solve = newton_graphs.NewtonSolve.__call__

    def broken(self, *args):
        res = solve(self, *args)
        if self.structure:
            return res._replace(state=res.state._replace(u=1.1 * res.state.u))
        return res._replace(traj=res.traj._replace(u=1.1 * res.traj.u))
    monkeypatch.setattr(newton_graphs.NewtonSolve, "__call__", broken)


def altered_control_minority(monkeypatch):
    """A control altered, 30% more, on a minority of the answers: on the
    last quarter of the lanes (a fault past a block or cluster boundary),
    or with one lane on two updates in five."""
    solve = newton_graphs.NewtonSolve.__call__
    calls = {"n": 0}

    def broken(self, *args):
        res = solve(self, *args)
        u = res.state.u if self.structure else res.traj.u
        batch = u.shape[0]
        scale = torch.ones((batch,) + (1,) * (u.dim() - 1), dtype=u.dtype,
                           device=u.device)
        if batch > 1:
            scale[batch - max(1, batch // 4):] = 1.3
        elif calls["n"] % 5 < 2:
            scale[:] = 1.3
        calls["n"] += 1
        if self.structure:
            return res._replace(state=res.state._replace(u=scale * u))
        return res._replace(traj=res.traj._replace(u=scale * u))
    monkeypatch.setattr(newton_graphs.NewtonSolve, "__call__", broken)


def half_the_batch(monkeypatch):
    """Half of the batch left out: the first half of the lanes rolled and
    counted, their outputs handed back for the rest."""
    make = rollouts.make_sharded_mpc_rollouts

    def broken(mesh, rollout_fn, ref, n_sample, idx_shift=(0,)):
        def half(q1, v1):
            n = max(1, q1.shape[0] // 2)
            out = rollout_fn(q1[:n], v1[:n])
            reps = -(-q1.shape[0] // n)
            return type(out)(*(x.repeat((reps,) + (1,) * (x.dim() - 1))
                               [:q1.shape[0]] for x in out))
        fn = make(mesh, half, ref, n_sample, idx_shift)

        def counted(q1, v1):
            traj, stats = fn(q1, v1)
            return traj, stats._replace(n_rollouts=stats.n_rollouts / 2)
        return counted
    monkeypatch.setattr(
        "benchmark.harness.drivers.sweep.make_sharded_mpc_rollouts", broken)


FAULTS = {"unchanged_state": unchanged_state,
          "altered_control": altered_control,
          "altered_control_minority": altered_control_minority,
          "half_the_batch": half_the_batch}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    if fault == "half_the_batch":
        if cell.traffic["driver"] != "sweep":
            pytest.skip("one lane: there is no half of the batch to leave out")
    FAULTS[fault](monkeypatch)
    line = tiny_run(cell)
    assert not line["correct"], line["checks"]
