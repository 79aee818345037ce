"""The control of ``correct``: the reference put in the program's place,
computed in float8 e4m3, has to fail the comparison that the program's
sound runs pass. On the CPU at a small size the control's widest gap
reads three times the program's or more, the separation the limits rest
on (the limits themselves are set from the card's readings at the cells'
sizes); on the card at the cells' own sizes it fails the comparison
(``pytest -m cuda``; ``python3 -m benchmark.control`` prints the readings
the limits are set from)."""

import pytest
import torch

from benchmark.lib import check, control
from benchmark.tests.cpu import cell, run_cpu, tiny


@pytest.mark.parametrize('name', ['lite4.sat64', 'lite4.live'])
def test_control_reads_far_above_the_program(name):
    shelf = tiny(cell(name))
    seed = 2 ** 31 + 3
    result, _, _ = run_cpu(shelf, seed=seed)
    assert result['correct'], result['compared']
    numbers, _ = control.control_numbers(shelf, seed, torch.device('cpu'))
    assert numbers['cand_gap']['value'] >= \
        3 * result['compared']['cand_gap']['value'], numbers


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['lite4.sat64', 'lite4.live'])
def test_control_fails_at_the_cell_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    full = cell(name)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        numbers, _ = control.control_numbers(full, seed,
                                             torch.device('cuda', 0))
        assert not check.passed(numbers), (seed, numbers)
