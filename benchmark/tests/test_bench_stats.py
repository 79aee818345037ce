"""The metrics' arithmetic on made-up records: rates over the whole
window, percentiles over every frame, the busy and idle shares of a
trace; a stall inside the window moves the rate and the tail."""

import os
import statistics

import numpy as np
import pytest

from benchmark.lib import records, spec, stats, trace, work


def reader(name):
    return spec.load_module(os.path.join(spec.BENCH_DIR, 'metrics',
                                         name + '.py')).read


def closed_record(step_s=0.1, n=50, frames=64, stall_at=None, stall_s=0.0):
    """A closed loop of ``n`` batches ``step_s`` apart, the one at
    ``stall_at`` waiting ``stall_s`` more in its resolve."""
    rows, t = [], 0.0
    for i in range(n):
        d0, d1 = t, t + 0.01
        r0 = d1
        r1 = t + step_s + (stall_s if i == stall_at else 0.0)
        rows.append((d0, d1, r0, r1, frames, 64, 0))
        t = r1
    table = np.asarray(rows, np.float64)
    names = ('dispatch0', 'dispatch1', 'resolve0', 'resolve1', 'frames',
             'bucket', 'backlog')
    batches = {k: table[:, i] for i, k in enumerate(names)}
    return {'batches': batches, 'window': (0.0, t), 'cut': t,
            'due': np.zeros(0), 'done': np.zeros(0), 'trace': None,
            'flops_per_frame': 4e9, 'setup_s': 12.5,
            'config': {'input_size': 300, 'watched': ['person', 'car'],
                       'union': 128}}


def open_record(latencies_ms, due_step=0.01):
    due = np.arange(len(latencies_ms)) * due_step
    rec = closed_record()
    rec.update(due=due, done=due + np.asarray(latencies_ms) / 1e3,
               cut=due[-1] + 1.0)
    return rec


def test_rate_is_all_frames_over_all_the_window():
    rec = closed_record(step_s=0.1, n=50, frames=64)
    assert reader('detect_fps')(rec) == pytest.approx(640.0)


def test_a_stall_moves_the_rate():
    steady = reader('detect_fps')(closed_record())
    stalled = reader('detect_fps')(closed_record(stall_at=25, stall_s=1.0))
    assert stalled == pytest.approx(50 * 64 / 6.0)
    assert stalled < 0.9 * steady


def test_p95_and_p50_over_every_frame():
    latencies = np.arange(1, 101, dtype=np.float64)        # 1..100 ms
    rec = open_record(latencies)
    assert reader('frame_latency_p95_ms')(rec) == pytest.approx(
        np.percentile(latencies, 95))
    assert reader('frame_latency_p50_ms.live')(rec) == pytest.approx(50.5)


def test_a_stall_moves_the_tail_not_the_median():
    base = np.full(1000, 20.0)
    stalled = base.copy()
    stalled[500:560] += 400.0          # frames caught behind a 0.4 s stall
    p95 = reader('frame_latency_p95_ms')
    p50 = reader('frame_latency_p50_ms.live')
    assert p95(open_record(base)) == pytest.approx(20.0)
    assert p95(open_record(stalled)) == pytest.approx(420.0)
    assert p50(open_record(stalled)) == pytest.approx(20.0)


def test_host_readers_leave_out_the_traced_slice():
    rec = closed_record(n=10)
    rec['batches']['dispatch1'][5:] += 0.05       # slower while profiled
    rec['cut'] = rec['batches']['dispatch0'][5]
    assert reader('dispatch_ms.sat')(rec) == pytest.approx(10.0)
    rec['cut'] = rec['window'][1]
    assert reader('dispatch_ms.sat')(rec) == pytest.approx(35.0)


def test_busy_and_idle_shares():
    spans = [(0, 10, 'a'), (5, 15, 'b'), (20, 30, 'c'), (29, 31, 'd')]
    assert stats.busy_us(spans) == 26
    assert stats.gaps(spans, 0, 40) == [(15, 20), (31, 40)]
    rec = closed_record()
    rec['trace'] = {'window_ns': (0, 40), 'device': spans,
                    'host': [(14, 21, 'resolve'), (31, 40, 'dispatch')]}
    assert reader('device_idle_pct.sat')(rec) == pytest.approx(35.0)
    out = trace.breakdown(rec['trace'])
    assert out['idle_gaps'] == [['dispatch', 9e-9], ['resolve', 5e-9]]
    assert out['device_ops'][0] == ['a', 1e-8]


def test_readers_without_a_trace_return_nothing():
    rec = closed_record()
    for name in ('device_idle_pct.sat', 'step_device_ms.sat',
                 'nms_fixed_point_roofline.sat'):
        assert reader(name)(rec) is None
    rec['trace'] = {'window_ns': (0, 10), 'device': [], 'host': []}
    assert reader('device_idle_pct.sat')(rec) is None
    assert reader('nms_fixed_point_roofline.sat')(rec) is None


def test_roofline_reads_its_kernel_against_its_bound():
    rec = closed_record(n=4)
    rec['cut'] = 0.0                      # all four batches in the slice
    nbytes, ops = work.fixed_point_work(64, 2, 128)
    bound_ms = work.Bound().add(nbytes, f32=ops).ms
    ns = bound_ms * 1e6 * 4               # four calls at 25% of the bound
    rec['trace'] = {'window_ns': (0, 10 ** 9), 'host': [],
                    'device': [(i * 10 ** 8, i * 10 ** 8 + ns,
                                'fixed_point_kernel(float const*)')
                               for i in range(4)]}
    assert reader('nms_fixed_point_roofline.sat')(rec) == pytest.approx(
        25.0, rel=1e-6)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [100.0, 101.0, 99.0, 100.5, 99.5, 100.0]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / q2)


def test_mfu_is_flops_times_rate_over_the_peak():
    rec = closed_record(step_s=0.1, n=50, frames=64)
    assert reader('step_mfu_pct.sat')(rec) == pytest.approx(
        100 * 4e9 * 640.0 / 989e12)


def test_records_cut_counts_only_resolved_frames():
    rec = closed_record(n=10)
    rec['cut'] = rec['batches']['resolve1'][4]
    assert records.frames_per_s(rec) == pytest.approx(640.0)


def test_confident_keeps_the_rows_whose_logit_clears_the_cut():
    from benchmark.lib import check
    scores = np.array([0.9, 0.5, 0.75, 1.0], np.float32)
    frame = (np.zeros((4, 4), np.float32), scores, np.array([1, 3, 1, 3]),
             np.zeros((4, 0), bool), 4)
    np.testing.assert_allclose(check.logit(scores[:3]),
                               [np.log(9.0), 0.0, np.log(3.0)], rtol=1e-6)
    sure = check.confident(frame, np.log(3.0) - 1e-6)
    np.testing.assert_array_equal(sure[1], scores[[0, 2, 3]])
    np.testing.assert_array_equal(sure[2], [1, 1, 3])
    assert sure[4] == 3
