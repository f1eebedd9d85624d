"""The MPC's Newton solve as replayed CUDA graphs (``control/graphs.py``)
against its eager route on the card.

The solves are those of the chip paths' own rollouts: the second Newton
call of a two-period run of path A (the hot path, structure mode, 16 lanes,
float32) and of path C (the same in direct mode, a 300 × 300 KKT a lane),
recorded with their arguments (``recorded_call``) and solved again by a
fresh ``NewtonSolve``:

- the replay equals the eager route (``NewtonSolve._eager``:
  ``structure_newton_solve`` / ``newton_solve``) bit for bit, on the first
  call (which captures) and on a second;
- the knot kernel's launches a replayed solve counts (``knot_ip.launches``,
  the launches its capture recorded added on each replay) equal the eager
  solve's on the same inputs;
- a second call with the same shapes captures nothing new, and structure
  mode replays no trip graph (one graph a solve), direct mode one a trip;
- float64: the knot kernel takes float32 only, so a Newton solve on the
  card is float32; the Newton's own linear algebra in float64, the direct
  mode's whole LDLᵀ at paths D's, I's and K's n = 480 and the structure
  mode's Riccati sweep at path A's stages, replays bit for bit against
  eager through the same capture (``utils/cuda_graphs.Captured``).

The tests are marked ``cuda`` and skip where CUDA is absent. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_newton_graphs_cuda.py
"""

from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from contactimplicitmpc_tpu_torch.control import graphs
from contactimplicitmpc_tpu_torch.control.graphs import NewtonSolve
from contactimplicitmpc_tpu_torch.control.structure_solver import (
    build_structure_objective, structure_kkt_solve)
from contactimplicitmpc_tpu_torch.env import flat_2d_lc
from contactimplicitmpc_tpu_torch.hotpath import (HotPathConfig,
                                                  conf_initial_states,
                                                  make_quadruped_rollout)
from contactimplicitmpc_tpu_torch.models.base import dims_of
from contactimplicitmpc_tpu_torch.models.quadruped import quadruped
from contactimplicitmpc_tpu_torch.ops.knot_ip import knot_ip
from contactimplicitmpc_tpu_torch.ops.linsolve import ldl_solve
from contactimplicitmpc_tpu_torch.utils.cuda_graphs import Captured

CONFIGS = {"A": HotPathConfig(),
           "C": HotPathConfig(newton_mode="direct")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test here, and the module's fixtures, run PyTorch on one
    thread: a batched LAPACK factorization (the pivoted-LU KKT backend) does
    not return on some CPU builds under a thread count between 2 and the
    core count, and one thread a test process keeps the processes from
    competing for the cores. Set here, not at import: a test process
    imports every test file, and the last import would win."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs replay on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def recorded_call(run, call=2):
    """(a fresh ``NewtonSolve`` like the one ``run()`` makes, the
    arguments of its ``call``-th Newton solve): ``run`` is a rollout of at
    least ``call`` control periods, its solves recorded as they are passed
    (the same tensors, views and all)."""
    seen = []
    original = NewtonSolve.__call__

    def record(self, *args):
        seen.append((self, args if len(seen) == call - 1 else None))
        return original(self, *args)

    with mock.patch.object(NewtonSolve, "__call__", record):
        run()
    solve, args = seen[call - 1]
    return NewtonSolve(solve.dims, solve.mode, solve.obj, solve.horizon,
                       solve.ip_opts, solve.opts, solve.newton_mode), args


def path_call(path, dev):
    """``recorded_call`` of a two-period run of chip path ``path``."""
    cfg = CONFIGS[path]
    roll, ref, model, _, _ = make_quadruped_rollout(
        cfg, 2 * cfg.n_sample, torch.float32, device=dev)
    q1s, v1s = conf_initial_states(model, ref)
    return recorded_call(lambda: roll(q1s, v1s))


def equal(got, want):
    """Every leaf of two results equal, bit for bit: {leaf: equal}."""
    a, b = tree_leaves(got), tree_leaves(want)
    assert type(got) is type(want) and len(a) == len(b) > 0
    return [bool(torch.equal(x, y)) for x, y in zip(a, b)]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def recorded(request, card):
    return request.param, *path_call(request.param, card)


@pytest.mark.cuda
def test_replay_equals_eager_bit_for_bit(recorded):
    path, solve, args = recorded
    assert solve.route(args[-1]) == "graphs"
    graphs.reset_stats()
    first = solve(*args)
    second = solve(*args)
    want = solve._eager(*args)
    torch.cuda.synchronize()
    print(f"path {path}: {dict(graphs.stats)}, iterations "
          f"{want.iterations.tolist()}")
    assert all(equal(first, want)), (path, equal(first, want))
    assert all(equal(second, want)), (path, equal(second, want))
    assert int(want.iterations.max()) > 0
    for x in tree_leaves(first):
        if x.is_floating_point():
            assert bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_knot_launches_through_replays_equal_eager(recorded):
    path, solve, args = recorded
    solve(*args)                               # captures
    counts = []
    for fn in (lambda: solve(*args), lambda: solve._eager(*args)):
        torch.cuda.synchronize()
        knot_ip.launches = 0
        fn()
        torch.cuda.synchronize()
        counts.append(knot_ip.launches)
    print(f"path {path}: knot launches replayed / eager {counts}")
    assert counts[0] == counts[1] > 0, counts


@pytest.mark.cuda
def test_second_call_captures_nothing_new(recorded):
    path, solve, args = recorded
    fresh = NewtonSolve(solve.dims, solve.mode, solve.obj, solve.horizon,
                        solve.ip_opts, solve.opts, solve.newton_mode)
    graphs.reset_stats()
    fresh(*args)
    after_first = dict(graphs.stats)
    fresh(*args)
    print(f"path {path}: first call {after_first}, both {graphs.stats}")
    assert after_first["sets"] == 1 and graphs.stats["sets"] == 1
    assert len(fresh.graph_sets) == 1
    assert graphs.stats["replays"] == 2 and graphs.stats["eager"] == 0
    assert graphs.stats["pool_bytes"] > 0
    if fresh.structure:
        assert graphs.stats["trips"] == 0
    else:
        assert graphs.stats["trips"] == 2 * after_first["trips"] > 0


def captured_against_eager(fn, dev):
    """``fn`` captured and replayed twice, and run eagerly: the three
    results."""
    stats = dict.fromkeys(("sets", "warmup_s", "capture_s", "pool_bytes"), 0)
    cap = Captured({"fn": fn}, fn, dev, stats)
    first = tuple(x.clone() for x in tree_leaves(cap.replay("fn")))
    second = tuple(x.clone() for x in tree_leaves(cap.replay("fn")))
    want = tuple(tree_leaves(fn()))
    torch.cuda.synchronize()
    return first, second, want


@pytest.mark.cuda
def test_float64_ldl_and_riccati_sweep_replay_bit_for_bit(card):
    rng = np.random.default_rng(5)
    f64 = dict(dtype=torch.float64, device=card)
    # a quasidefinite KKT a lane at n = 480 (paths D, I and K): [P Bᵀ; B −R]
    n_p, n_d, lanes = 300, 180, 16
    g = lambda *s: torch.as_tensor(rng.standard_normal(s), **f64)
    p, r = g(lanes, n_p, n_p), g(lanes, n_d, n_d)
    p = p @ p.mT / n_p + torch.eye(n_p, **f64)
    r = r @ r.mT / n_d + 1e-3 * torch.eye(n_d, **f64)
    b = 0.1 * g(lanes, n_d, n_p)
    kkt = torch.cat([torch.cat([p, b.mT], -1), torch.cat([b, -r], -1)], -2)
    rhs = g(lanes, n_p + n_d)
    got, again, want = captured_against_eager(lambda: ldl_solve(kkt, rhs),
                                              card)
    assert torch.equal(got[0], want[0]) and torch.equal(again[0], want[0])
    assert bool(torch.isfinite(want[0]).all())

    # the structure mode's KKT at path A's widths and H = 10
    dims = dims_of(quadruped, flat_2d_lc)
    h, nq, nu = 10, dims.nq, dims.nu
    w = lambda k: torch.as_tensor(np.abs(rng.standard_normal((h + 1, k)))
                                  + 0.1, **f64)
    sobj = build_structure_objective(dims, w(nq), w(nq), w(nu), 1e-5, h)
    jac = lambda k: 0.3 * g(lanes, h, nq, k)
    res = lambda k: g(lanes, h, k)
    args = (jac(nq), jac(nq), jac(nu), res(nu), res(nq), res(nq), res(nq),
            res(nq))
    got, again, want = captured_against_eager(
        lambda: structure_kkt_solve(dims, sobj, *args, 1e-5, h), card)
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, z) and torch.equal(y, z)
        assert bool(torch.isfinite(z).all())
