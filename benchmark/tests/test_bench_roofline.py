"""The benchmark's frozen operation and byte counts equal the program's own
``work`` at the shapes the cells run (a later change to a kernel may change
the program's; the benchmark's stay)."""

import pytest

from benchmark.reference.cimpc.env import flat_2d_lc, flat_3d_lc
from benchmark.reference.cimpc.models.base import dims_of
from benchmark.reference.cimpc.models.centroidal_quadruped import \
    centroidal_quadruped
from benchmark.reference.cimpc.models.quadruped import quadruped
from benchmark.roofline import knot_ip, ldl, least_seconds, sim_ip, \
    structure_kkt
from contactimplicitmpc_tpu_torch.models import quadruped as port_quadruped
from contactimplicitmpc_tpu_torch.models.base import dims_of as port_dims
from contactimplicitmpc_tpu_torch.models.centroidal_quadruped import \
    centroidal_quadruped as port_centroidal
from contactimplicitmpc_tpu_torch.env import flat_2d_lc as port_flat_2d
from contactimplicitmpc_tpu_torch.env import flat_3d_lc as port_flat_3d
from contactimplicitmpc_tpu_torch.ops import knot_ip as port_knot
from contactimplicitmpc_tpu_torch.ops import ldl as port_ldl
from contactimplicitmpc_tpu_torch.ops import sim_ip as port_sim
from contactimplicitmpc_tpu_torch.ops import structure_kkt as port_kkt


def as_dict(d):
    return dict(nx=d.nx, ny=d.ny, nz=d.nz, ntheta=d.ntheta, nq=d.nq, nc=d.nc)


@pytest.mark.parametrize("which", ["quadruped", "centroidal"])
@pytest.mark.parametrize("lanes", [1, 16, 128, 1024])
def test_knot_ip_work(which, lanes):
    model, env, pmodel, penv, knots = {
        "quadruped": (quadruped, flat_2d_lc, port_quadruped, port_flat_2d, 9),
        "centroidal": (centroidal_quadruped, flat_3d_lc, port_centroidal,
                       port_flat_3d, 10)}[which]
    ours, theirs = dims_of(model, env), port_dims(pmodel, penv)
    for n in (lanes * knots, lanes * 7 * knots):
        assert knot_ip.work(as_dict(ours), n, knots, 8, 1, 3) == \
            port_knot.work(theirs, n, knots, 8, 1, 3)


@pytest.mark.parametrize("batch", [1, 16, 1024])
@pytest.mark.parametrize("elem", [4, 8])
def test_kkt_work(batch, elem):
    assert structure_kkt.work(11, 8, 10, batch, elem) == \
        port_kkt.work(11, 8, 10, batch, elem)
    assert ldl.work(480, batch, elem) == port_ldl.work(480, batch, elem)


@pytest.mark.parametrize("n,trips", [(16, 160), (1024, 9000), (1, 24)])
@pytest.mark.parametrize("refine", [0, 1])
def test_sim_ip_work(n, trips, refine):
    assert sim_ip.work(n, trips, 6, refine, 4) == \
        port_sim.work(n, trips, 6, refine, 4)


def test_least_seconds_matches_the_program_bounds():
    for elem in (4, 8):
        flops, nbytes = ldl.work(480, 128, elem)
        ms, which = port_ldl.bound_ms(480, 128, elem)
        seconds, ours = least_seconds(flops, nbytes, elem)
        assert ours == which and abs(1e3 * seconds - ms) <= 1e-12 * ms
