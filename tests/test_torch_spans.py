"""The program's spans (watsor_tpu_torch/runtime/spans.py) on the CPU: off
without a profiler capture, recorded under one with parents, batches and
counts on the profiler's clock, and emitted by the backend, the detector
task and ``/profiler``."""

import json
import os
import threading
import time
import types
from queue import Queue

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from watsor_tpu_torch.detection.backend import (FleetBackend,
                                                TorchDetectorBackend)
from watsor_tpu_torch.detection.detector import ObjectDetector
from watsor_tpu_torch.filters.mask import ZoneMask
from watsor_tpu_torch.main import TorchApplication
from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
from watsor_tpu_torch.ops import filter_device
from watsor_tpu_torch.parallel import FleetDetector, make_mesh
from watsor_tpu_torch.runtime import spans
from watsor_tpu_torch.runtime.frames import FrameBuffer, State
from watsor_tpu_torch.runtime.tasks import Payload

DISPATCH = ('backend.stage_wait', 'backend.fill', 'backend.h2d',
            'backend.step', 'backend.filters', 'backend.pack')
RESOLVE = ('backend.wait', 'backend.fetch', 'backend.unpack',
           'backend.refine')
DETECT = [{'person': {'confidence': 30, 'area': 1, 'zones': [2]}},
          {'car': {'confidence': 50, 'area': 0.5, 'zones': []}}]


class capture:
    """A torch.profiler capture as the benchmark's traced slice runs one
    (``start()`` and ``stop()``), with the process's recorder emptied
    first; ``events`` holds its CPU events after."""

    def __enter__(self):
        spans.clear()
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()
        return False


def _by_name(records):
    out = {}
    for record in records:
        out.setdefault(record.name, []).append(record)
    return out


def test_off_records_nothing_and_returns_the_shared_null():
    recorder = spans.Recorder()
    assert not torch.autograd.profiler._is_profiler_enabled
    outer = recorder.span('a', batch=spans.NEXT, frames=3)
    assert outer is spans.NULL and spans.span('b') is spans.NULL
    with outer as traced:
        with recorder.span('b') as inner:
            inner.count(rows=2)
        assert traced.batch is None and traced.id is None
    assert recorder.records() == []


def test_nested_spans_record_parents_batches_and_counts():
    recorder = spans.Recorder()
    with capture():
        with recorder.span('dispatch', batch=spans.NEXT, frames=3) as first:
            with recorder.span('fill', bytes=12):
                with recorder.span('copy') as copy:
                    copy.count(rows=3)
        with recorder.span('dispatch', batch=spans.NEXT) as second:
            pass
        with recorder.span('resolve', batch=first.batch):
            with recorder.span('wait'):
                pass
        with recorder.span('loose'):
            pass
    got = _by_name(recorder.records())
    fill, = got['fill']
    copy, = got['copy']
    wait, = got['wait']
    resolve, = got['resolve']
    loose, = got['loose']
    assert [r.batch for r in got['dispatch']] == [first.batch, second.batch]
    assert second.batch == first.batch + 1
    assert fill.parent == first.id and copy.parent == fill.id
    assert fill.batch == copy.batch == first.batch
    assert resolve.batch == wait.batch == first.batch
    assert wait.parent == resolve.id and resolve.parent is None
    assert loose.batch is None and loose.parent is None
    assert got['dispatch'][0].counts == {'frames': 3}
    assert fill.counts == {'bytes': 12} and copy.counts == {'rows': 3}
    for record in recorder.records():
        assert record.start_ns <= record.end_ns
    assert copy.start_ns >= fill.start_ns and copy.end_ns <= fill.end_ns
    # a finished span's record is its own: records() returns a copy
    recorder.records().clear()
    assert len(recorder.records()) == 7
    recorder.clear()
    assert recorder.records() == []


def test_the_deque_drops_its_oldest_span_past_its_bound():
    recorder = spans.Recorder(capacity=3)
    with capture():
        for k in range(5):
            with recorder.span('s{}'.format(k)):
                pass
    assert [r.name for r in recorder.records()] == ['s2', 's3', 's4']


def test_each_span_lies_within_1_ms_of_its_profiler_event():
    """The spans' clock is the profiler's: each span's start and end lie
    within 1 ms of those of the record_function event it opened."""
    recorder = spans.Recorder()
    # the first record_function of a process resolves the profiler's ops
    with capture():
        with recorder.span('warm'):
            pass
    names = ['outer', 'inner.0', 'inner.1', 'inner.2']
    with capture() as traced:
        with recorder.span('outer'):
            for name in names[1:]:
                with recorder.span(name):
                    time.sleep(0.002)
    events = {e.name(): e for e in traced.events if e.name() in names}
    assert set(events) == set(names)
    for record in recorder.records():
        if record.name == 'warm':
            continue
        event = events[record.name]
        assert abs(record.start_ns - event.start_ns()) < 1_000_000
        assert abs(record.end_ns - event.end_ns()) < 1_000_000
        assert record.end_ns - record.start_ns >= 1_000_000 or \
            record.name == 'outer'


def test_summary_sums_calls_times_and_counts():
    Span = spans.Span
    records = [Span(1, 'a', 0, 2_000_000, None, 1, {'frames': 3}),
               Span(2, 'a', 5_000_000, 9_000_000, None, 2,
                    {'frames': 5, 'bucket': 8}),
               Span(3, 'b', 0, 500_000, 1, 1, {})]
    got = spans.summary(records)
    assert got['a'] == {'calls': 2, 'total_ms': 6.0, 'mean_ms': 3.0,
                        'counts': {'frames': 8, 'bucket': 8}}
    assert got['b'] == {'calls': 1, 'total_ms': 0.5, 'mean_ms': 0.5,
                        'counts': {}}


@pytest.fixture(scope='module')
def watched_detector():
    cfg = SSDConfig(num_classes=90, input_size=96, dtype=torch.float32,
                    nms_mode='fused_exact', active_labels=(1, 3),
                    score_threshold=0.0)
    return build_detector(cfg, seed=0, device='cpu')


def _tables():
    alpha = np.zeros((120, 160), np.uint8)
    alpha[5:60, 5:80] = 255
    alpha[60:115, 70:155] = 255
    mask = ZoneMask(alpha, (120, 160, 3))
    tables = {}
    for name, zones in (('a', mask), ('b', None)):
        conf, area = filter_device.threshold_tables(DETECT)
        tables[name] = (conf, area) + tuple(
            filter_device.zone_tables(zones, DETECT))
    return tables, {'a': filter_device.ZoneRefiner(mask, DETECT)}


@pytest.mark.parametrize('kind', ['single', 'fleet'])
def test_backend_dispatch_and_resolve_emit_every_span(watched_detector,
                                                      kind):
    """Both backends' dispatch and resolve, with camera filters and a zone
    refiner: every backend span, one batch number from dispatch through
    resolve, and the dispatch's frames and bucket."""
    tables, refiners = _tables()
    if kind == 'single':
        backend = TorchDetectorBackend(watched_detector, 'cpu',
                                       camera_tables=tables,
                                       zone_refiners=refiners)
    else:
        fleet = FleetDetector(make_mesh(devices=['cpu', 'cpu']),
                              watched_detector)
        backend = FleetBackend(fleet, camera_tables=tables,
                               zone_refiners=refiners)
    frames = np.random.default_rng(2).integers(0, 256, (3, 96, 96, 3),
                                               np.uint8)
    with capture():
        result = backend.resolve(backend.dispatch(frames,
                                                  senders=['a', 'b', 'a']))
    assert result[0].shape == (3, 100, 4)
    got = _by_name(spans.records())
    dispatch, = got.pop('backend.dispatch')
    resolve, = got.pop('backend.resolve')
    assert set(got) == set(DISPATCH + RESOLVE)
    assert dispatch.counts == {'frames': 3, 'bucket': 4}
    assert dispatch.batch is not None and resolve.batch == dispatch.batch
    for name in DISPATCH + RESOLVE:
        parent = dispatch if name in DISPATCH else resolve
        for record in got[name]:
            assert record.batch == dispatch.batch
            assert parent.start_ns <= record.start_ns <= record.end_ns <= \
                parent.end_ns
    fill, = got['backend.fill']
    assert fill.counts == {'bytes': 4 * 96 * 96 * 3}
    refine, = got['backend.refine']
    assert refine.counts['rows'] >= 0
    shards = 2 if kind == 'fleet' else 1
    assert len(got['backend.step']) == len(got['backend.wait']) == shards


class _Backend:
    """A dispatch/resolve backend that detects nothing."""

    device_name = 'FAKE'
    input_hw = (48, 64)

    def warmup(self, hw=None, batch=1):
        pass

    def dispatch(self, images_u8, senders=None):
        return images_u8.shape[0]

    def resolve(self, n):
        return (np.zeros((n, 100, 4), np.float32),
                np.zeros((n, 100), np.float32),
                np.zeros((n, 100), np.int32), np.zeros((n,), np.int32), 1.0)


def test_object_detector_emits_gather_stage_and_scatter():
    # 160x120 frames, each resized to the backend's 64x48 input
    buffer = FrameBuffer(4, 160, 120)
    queue = Queue()
    detector = ObjectDetector('det', queue, {'cam': buffer}, _Backend(),
                              max_batch=2, batch_window_ms=0.0)
    frames = []
    with capture():
        detector.start()
        try:
            assert detector.ready.wait(10)
            for index in range(4):
                frame = buffer.frames[index]
                frame.clear()
                frame.stamp()
                frame.latch.next()                 # READY -> DETECT
                queue.put(Payload('cam', index))
                frames.append(frame)
            deadline = time.time() + 10
            while time.time() < deadline and any(
                    f.latch.state == State.DETECT for f in frames):
                time.sleep(0.01)
        finally:
            detector.terminate()
            detector.join(10)
    assert not detector.is_alive()
    assert all(f.latch.state != State.DETECT for f in frames)
    got = _by_name(spans.records())
    assert sum(r.counts['frames'] for r in got['detector.gather']) == 4
    assert sum(r.counts['resized'] for r in got['detector.stage']) == 4
    scatters = got['detector.scatter']
    assert sum(r.counts['frames'] for r in scatters) == 4
    assert all(r.counts['dropped'] == 0 for r in scatters)
    ids = {r.id for r in scatters}
    for name in ('detector.scatter.write', 'detector.scatter.latch',
                 'detector.scatter.meters'):
        assert len(got[name]) == 4
        assert all(r.parent in ids for r in got[name])


def test_profiler_endpoint_sums_the_captures_spans(tmp_path):
    """``/profiler``'s answer sums the spans recorded during its capture,
    by name, with none from before it; another thread's spans count."""
    spans.clear()
    app = types.SimpleNamespace(
        _profiler_lock=threading.Lock(),
        _PROFILER_KEEP=TorchApplication._PROFILER_KEEP,
        _args=types.SimpleNamespace(log_path=str(tmp_path)))
    stop = threading.Event()

    def work():
        while not stop.is_set():
            with spans.span('backend.dispatch', batch=spans.NEXT, frames=2,
                            bucket=2):
                time.sleep(0.001)

    worker = threading.Thread(target=work)
    worker.start()
    try:
        request = types.SimpleNamespace(args={'seconds': '0.3'})
        response = TorchApplication._profiler_response(app, request)
    finally:
        stop.set()
        worker.join(10)
    assert not worker.is_alive()
    body = json.loads(response.get_data())
    assert response.status_code == 200 and body['seconds'] == 0.3
    summary = body['spans']['backend.dispatch']
    assert summary['calls'] >= 1
    assert summary['counts'] == {'frames': 2 * summary['calls'],
                                 'bucket': 2 * summary['calls']}
    assert summary['mean_ms'] == pytest.approx(
        summary['total_ms'] / summary['calls'])
    with open(os.path.join(body['trace_dir'], 'trace.json')) as f:
        assert '"backend.dispatch"' in f.read()
