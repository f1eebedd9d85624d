"""Whether what the timed path produced is correct: the comparison with the
plain reference, after the window has closed.

A record is one completed rollout (or episode) of the window, on the host:
``q1`` the lanes' initial configurations as the benchmark handed them in,
``q`` (B, T + 2, nq) and ``u`` (B, T, nu) per sim step as the program
returned them, ``conv`` (B, T) its sim steps' convergence, ``n`` the lanes
its statistics counted, and where the program reports it ``newton_r``
(B, T / N_sample), each control update's final Newton residual. The
numbers compared:

* ``start_gap``: the largest difference between a lane's returned q[1]
  and the configuration handed in for it, over every lane (exact: 0);
* ``lanes_gap``: the largest difference between the lanes a rollout's
  statistics counted and the lanes handed in (exact: 0);
* ``sim_q_gap``: over a sample of the sim steps of the lanes that
  converged at every step (of those whose reference solve converged, at
  its tolerances, 1e-8), the largest difference (m or rad) between the configuration
  a step ended in and the reference's solve of the same contact NCP, from
  the two configurations and the control the step started from;
* ``sim_residual``: over the same sample, the largest entry of the
  dynamics rows of the reference's NCP residual at the program's answer
  (q2 and the contact impulses γ, b it returned), in the model's momentum
  units: a step that does not hold momentum balance reads high even where
  it moves little;
* ``control_gap`` and ``control_lane_gap``: over a sample of those lanes
  and their first control updates, the gaps |u − u_ref|∞ / |u_ref|∞, u
  the control an update sent and u_ref the reference's: its closed loop
  of the same lane replayed from update 0, each update from the
  configurations the lane observed and warm-started from the reference's
  own update before it by the program's rule
  (``reference/mpc.py::closed_loop``). Only updates whose Newton reached
  its tolerance on both sides count (the program's side where it reports
  its residual). ``control_gap`` is the 75th percentile of all of them,
  ``control_lane_gap`` the largest of the lanes' medians: a fault on a
  quarter of the updates moves the first, a fault on one sampled lane
  the second. Neither is the largest gap: the tolerance is loose on u,
  and where the two sides' iterations part at one update (a line search
  that accepts another step in float32), the warm starts that follow
  part too, on one lane in some, for an update or two in the structure
  mode, for the rest of the rollout in the direct mode.

The sample is drawn from the seed. ``control_numbers`` reads the same
numbers for the comparison's control: the reference computed in a lower
type, put in the program's place on the same sample.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import traffic as draws


def sample(records, check: dict, seed: int) -> dict:
    """The steps and lanes to compare, among the lanes whose every sim
    step converged (a lane with a failed step is counted in ``failed``;
    its later states are not an answer): ``check["sim_steps"]`` sim steps
    (record, lane, step) over every step, and ``check["lanes"]`` lanes
    (record, lane) whose first ``check["updates"]`` control updates are
    compared (the reference replays each lane's closed loop from update
    0, one update after the other)."""
    rng = draws.rng(seed, draws.CHECK)
    pairs = [(ri, int(b)) for ri, r in enumerate(records)
             for b in np.flatnonzero(r["conv"].all(axis=1))]
    if not pairs:        # no lane to compare: every number reads NaN
        return {"steps": [], "lanes": [], "updates": 0}
    n_steps = records[0]["u"].shape[1]
    picks = rng.choice(len(pairs) * n_steps, replace=False,
                       size=min(check["sim_steps"], len(pairs) * n_steps))
    steps = [pairs[i // n_steps] + (int(i % n_steps),) for i in sorted(picks)]
    lanes = [pairs[i] for i in sorted(rng.choice(
        len(pairs), size=min(check["lanes"], len(pairs)), replace=False))]
    return {"steps": steps, "lanes": lanes, "updates": check["updates"]}


def _sim_inputs(records, steps):
    pick = lambda key, dt: np.stack([records[r][key][b, t + dt]
                                     for r, b, t in steps])
    return ((pick("q", 0), pick("q", 1), pick("u", 0)),
            (pick("q", 2), pick("gamma", 0), pick("b", 0)))


def _lane_updates(records, lanes, n_sample, n_updates):
    """(q_obs, u) (L, K, ·): the configuration each sampled lane observed
    at each of its first K updates (at most ``n_updates``), and the
    control the update sent for a whole period."""
    n_updates = min(n_updates, records[0]["u"].shape[1] // n_sample)
    at = n_sample * np.arange(n_updates)
    q_obs = np.stack([records[r]["q"][b, 1 + at] for r, b in lanes])
    u = np.stack([records[r]["u"][b, at] for r, b in lanes])
    return q_obs, u * n_sample


def _rel(u, u_ref):
    u, u_ref = (np.asarray(x, dtype=np.float64) for x in (u, u_ref))
    return np.abs(u - u_ref).max(axis=1) / np.maximum(
        np.abs(u_ref).max(axis=1), 1e-12)


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _control(rel, mask) -> dict:
    """The two control numbers of gaps ``rel`` (L, K) over ``mask``; NaN
    where nothing is compared."""
    if not mask.any():
        return {"control_gap": float("nan"),
                "control_lane_gap": float("nan")}
    lanes = [np.median(r[m]) for r, m in zip(rel, mask) if m.any()]
    return {"control_gap": float(np.quantile(rel[mask], 0.75)),
            "control_lane_gap": float(max(lanes))}


class Comparison:
    """The reference's answers on a sample, worked out once, against
    which the program's and the control's are read. ``rule`` is the
    program's warm-start rule on the timed path."""

    def __init__(self, reference, records, picked, n_sample: int, rule):
        self.records, self.picked, self.rule = records, picked, rule
        self.ref_ok, self.mask = np.zeros(0, bool), np.zeros((0, 0), bool)
        self.seconds = {}
        if not picked["steps"]:
            return
        self.reference = reference
        self.sim_in, self.sim_out = _sim_inputs(records, picked["steps"])
        self.q2 = self.sim_out[0]
        self.q_obs, self.u = _lane_updates(records, picked["lanes"],
                                           n_sample, picked["updates"])
        with torch.no_grad():
            began = time.perf_counter()
            q2_ref, _, _, conv = reference.sim_step(*self.sim_in)
            self.q2_ref = q2_ref.cpu().numpy()
            self.ref_ok = conv.cpu().numpy()
            self.seconds = {"sim": time.perf_counter() - began}
            reference.lin
            self.seconds["linearization"] = (time.perf_counter() - began
                                             - self.seconds["sim"])
            u_ref, newton_ok = reference.closed_loop(self.q_obs, rule)
            self.u_ref = u_ref.cpu().numpy()
            self.mask = newton_ok.cpu().numpy()
            self.seconds["closed_loop"] = (time.perf_counter() - began
                                           - sum(self.seconds.values()))
            if "newton_r" in records[0]:
                r_norm = np.stack([records[r]["newton_r"][b, :self.u.shape[1]]
                                   for r, b in picked["lanes"]])
                self.mask &= reference.newton_converged(
                    torch.as_tensor(r_norm, dtype=torch.float64)).numpy()

    def program_numbers(self) -> dict:
        recs = self.records
        start = max(_gap(r["q"][:, 1], r["q1"]) for r in recs)
        lanes = max(abs(r["n"] - r["q1"].shape[0]) for r in recs)
        out = {"start_gap": start, "lanes_gap": float(lanes)}
        if self.picked["steps"]:
            out.update(sim_q_gap=self._q_gap(self.q2),
                       sim_residual=self._residual(self.sim_out),
                       **_control(self._rel(self.u), self.mask))
        return out

    def _rel(self, u):
        shape = self.u_ref.shape
        return _rel(np.reshape(u, (-1, shape[-1])),
                    self.u_ref.reshape(-1, shape[-1])).reshape(shape[:2])

    def _q_gap(self, q2) -> float:
        """The gap over the samples whose reference solve converged (the
        reference judges no other); NaN where none did."""
        if not self.ref_ok.any():
            return float("nan")
        return _gap(np.asarray(q2)[self.ref_ok], self.q2_ref[self.ref_ok])

    def _residual(self, answer) -> float:
        with torch.no_grad():
            return float(self.reference.momentum_residual(
                *self.sim_in, *answer).max())

    def compared(self) -> tuple:
        """(control updates compared, sampled), for the run's log."""
        return int(self.mask.sum()), int(self.mask.size)

    def worst(self) -> dict:
        """Where the sim and control gaps are largest, for a look."""
        if not self.picked["steps"]:
            return {}
        sim = np.abs(self.q2 - self.q2_ref).max(axis=1)
        i = int(np.argmax(sim))
        rel = self._rel(self.u)
        masked = np.where(self.mask, rel, -1.0)
        lane, k = np.unravel_index(int(np.argmax(masked)), rel.shape)
        return {"sim_step": self.picked["steps"][i], "sim_gap": float(sim[i]),
                "q2": self.q2[i].tolist(), "q2_ref": self.q2_ref[i].tolist(),
                "sim_ref_converged": int(self.ref_ok.sum()),
                "control": {"lane": self.picked["lanes"][int(lane)],
                            "update": int(k), "gap": float(rel[lane, k])},
                "control_compared": self.compared(),
                "control_rel": rel.tolist(),
                "control_mask": self.mask.astype(int).tolist()}

    def control_numbers(self, low) -> dict:
        """The numbers of the reference ``low`` in the program's place,
        on the same sample (the same updates count)."""
        with torch.no_grad():
            answer = [x.double().cpu().numpy() for x in low.sim_step(
                *(np.asarray(x, np.float64) for x in self.sim_in))[:3]]
            u = low.closed_loop(self.q_obs, self.rule)[0]
            u = u.double().cpu().numpy()
        rel = self._rel(u)
        return {"sim_q_gap": self._q_gap(answer[0]),
                "sim_residual": self._residual(answer),
                **_control(rel, self.mask), "control_rel": rel.tolist()}


def compare(cell, records, rule, seed: int, device) -> Comparison:
    """The comparison of a run's records, the reference built anew on
    ``device`` (its arithmetic is float64 there as on the host)."""
    reference = cell.reference().reference(cell.config, device=device)
    picked = sample(records, cell.traffic["check"], seed)
    return Comparison(reference, records, picked,
                      cell.config["mpc"]["n_sample"], rule)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit, in the limits'
    order; a number that is not finite, or is missing, fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        correct &= bool(np.isfinite(value) and value <= limit)
    return correct, checks
