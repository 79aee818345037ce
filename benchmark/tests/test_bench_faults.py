"""A run of each cell's traffic on the CPU at a small scale, past the
harness's look for a card: sound, ``correct`` holds; with each fault a
cell can have planted under the timed path (a step that returns its state
unchanged, half of the batch computed on blank frames, the frames of a
batch handed each other's answers, an answer altered where it is
produced), ``correct`` comes out false. One chip, so no exchange between
chips to leave out. The limits are the configurations' own."""

import pytest

from benchmark.lib import faults
from benchmark.tests import cpu
from benchmark.tests.cpu import run_cpu, tiny

CELLS = ['lite4.sat64', 'lite4.live']


def cell(name):
    # at the cells' own input size: at a smaller one the seeded network's
    # most confident anchors hardly depend on the frame
    return tiny(cpu.cell(name), size=640)


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name):
    result, lines, _ = run_cpu(cell(name))
    assert result['correct'], lines
    assert result['failed'] == 0 and result['attempted'] > 0


@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
@pytest.mark.parametrize('name', CELLS)
def test_planted_fault_is_caught(name, fault):
    with faults.FAULTS[fault]():
        result, lines, _ = run_cpu(cell(name))
    assert not result['correct'], lines


def test_results_name_each_number_beside_its_limit():
    result, lines, _ = run_cpu(cell('lite4.sat64'))
    assert list(result)[-1] == 'compared'
    assert set(result['compared']) == {'cand_gap', 'unmatched_share',
                                       'rule_breaks'}
    for name, number in result['compared'].items():
        assert set(number) == {'value', 'limit'}
    assert lines[0].startswith('setup: ')
    assert len(lines) == 4 and all(line.startswith('compared ')
                                   for line in lines[1:])
