"""The comparison's control, the reference computed in bfloat16 in the
program's place, comes out not correct on the cells' limits; the program
on the same sample comes out correct. At a test's size on the CPU; the
readings that set the limits come from ``tools/readings.py`` on the card
at the cells' own sizes."""

import pytest
import torch

from benchmark.harness import judge
from benchmark.reference.lowp import factorisations_in_low_precision
from benchmark.tests.tiny import tiny_cell
from benchmark.tools.readings import readings


@pytest.mark.parametrize("name", ["quadruped-sweep", "centroidal-sweep",
                                  "quadruped-rt"])
def test_control_fails_the_limits(name):
    cell = tiny_cell(name)
    out = readings(cell, 2 ** 31 + 3, 1.0, torch.device("cpu"), True)
    assert judge.verdict(out["program"], cell.limits)[0], out
    control = {**out["program"], **out["control"]}
    assert not judge.verdict(control, cell.limits)[0], out


def test_low_precision_factorisations_restore():
    a = torch.eye(3, dtype=torch.bfloat16) * 2
    inv = torch.linalg.inv
    with factorisations_in_low_precision():
        assert torch.linalg.inv(a).dtype == torch.bfloat16
    assert torch.linalg.inv is inv
