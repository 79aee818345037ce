"""The readers of the program's own spans (``lib/spans.py``) on both cells
cut small and traced on the CPU: the span and count readers give numbers,
the device's idle share inside the fill gives None without device events,
and every one gives None where the program has no recorder, as a checkout
from before it."""

import sys

import pytest
import torch

from benchmark.tests.cpu import cell, run_cpu, tiny

SPANS = ('fill_ms', 'launch_ms', 'step_wait_ms')
CELLS = {'sat': 'lite4.sat64', 'live': 'lite4.live'}


@pytest.fixture(scope='module', params=sorted(CELLS))
def traced(request):
    """(suffix, result, record) of a traced run of the cell at 128x128
    with two cameras (the comparison is not read here): batches short
    enough that the slice holds many of them on a loaded CPU."""
    suffix = request.param
    small = tiny(cell(CELLS[suffix]), size=128, cameras=2, max_batch=2,
                 trace_seconds=3.0)
    # two torch threads, as conftest.py's few_threads gives each test: a
    # module's fixture is set up before it
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result, _, rec = run_cpu(small, seconds=5.0, traced=True)
    finally:
        torch.set_num_threads(saved)
    return suffix, result, rec


def test_the_span_readers_read_the_slice(traced):
    suffix, result, _ = traced
    metrics = result['metrics']
    for name in SPANS:
        assert metrics[name + '.' + suffix]['value'] > 0, name
    assert metrics['launch_ms.' + suffix]['value'] > \
        metrics['fill_ms.' + suffix]['value']
    assert 'idle_in_fill_pct.' + suffix not in metrics
    if suffix == 'live':
        assert 0 <= metrics['padded_pct.live']['value'] < 100


def test_without_the_recorder_every_reader_gives_none(traced, monkeypatch):
    suffix, _, rec = traced
    import watsor_tpu_torch.runtime as runtime
    monkeypatch.delattr(runtime, 'spans')
    monkeypatch.setitem(sys.modules, 'watsor_tpu_torch.runtime.spans', None)
    small = cell(CELLS[suffix])
    names = [m['name'] for m in small.per_layer
             if m['source'] in ('program_span', 'program_counter') and
             m['name'] != 'batch_frames.live']
    assert len(names) == 4 + (suffix == 'live')
    for name in names:
        assert small.reader(name)(rec) is None, name


def test_the_span_report_splits_the_slices_batches(traced):
    """``tools/span_report.py`` on the same traced run: every dispatch's
    children are the backend's named phases and cover it, each program
    dispatch is paired with the harness's around it, and without device
    events no idle time is named."""
    from benchmark.tools import span_report
    suffix, _, rec = traced
    got = span_report.report(rec)
    dispatch = got['dispatch']
    assert dispatch['batches'] > 0
    assert set(dispatch['children_self_ms']) >= {
        'backend.fill', 'backend.h2d', 'backend.step', 'backend.filters',
        'backend.pack'}
    assert 0 < dispatch['cover_min_pct'] <= 100
    assert set(got['resolve']['children_self_ms']) >= {
        'backend.wait', 'backend.fetch', 'backend.unpack'}
    assert got['harness_less_program_ms']['batches'] >= \
        dispatch['batches'] - 1
    assert got['idle_by_span'] is None and got['longest_gaps'] is None
    assert got['dispatch_ms']['in_slice_batches'] > 0


def test_the_span_report_names_each_idle_instant_by_its_innermost_span():
    from benchmark.tools import span_report
    segments = span_report.innermost(
        [(0, 100, 'backend.dispatch'), (10, 40, 'backend.fill')],
        [(0, 100, 'bench.dispatch'), (100, 150, 'bench.wait')])
    assert segments == [(0, 10, 'backend.dispatch'),
                        (10, 40, 'backend.fill'),
                        (40, 100, 'backend.dispatch'),
                        (100, 150, 'bench.wait')]
    named = span_report.name_gaps([(5, 20), (90, 160)], segments)
    assert named == [{'backend.dispatch': 5, 'backend.fill': 10},
                     {'backend.dispatch': 10, 'bench.wait': 50, 'other': 10}]


def test_the_span_report_pairs_each_dispatch_with_the_harness_around_it():
    """A program dispatch whose stamps sit a little outside the harness's
    is still its pair; one that overlaps it by half or less is not."""
    from types import SimpleNamespace

    from benchmark.tools import span_report

    def dispatch(start, end):
        return SimpleNamespace(name='backend.dispatch', start_ns=start,
                               end_ns=end)
    trace = {'host': [(100, 200, 'dispatch'), (300, 400, 'dispatch'),
                      (500, 600, 'dispatch'), (600, 700, 'wait')]}
    found = [dispatch(98, 190), dispatch(310, 390), dispatch(560, 660)]
    assert span_report.harness_less_program(trace, found) == \
        [8 / 1e6, 20 / 1e6]


def test_the_span_report_times_a_span_with_and_without_a_capture():
    from benchmark.tools import span_report
    from watsor_tpu_torch.runtime import spans
    cost = span_report.span_cost(calls=200)
    assert set(cost) == {'off', 'on', 'record_function_on'}
    assert all(v > 0 for v in cost.values())
    assert spans.records() == []
