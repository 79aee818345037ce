"""The detector backend on the card, at Lite4's size: ``dispatch`` queues
the step without a synchronising call, batches in flight resolve to their
own results, and ``resolve`` finds the step still running; at
RetinaNet-50's, the forward's stage spans stamp the device (run on the
card: pytest -m cuda).

This file imports nothing of the JAX package: the card's machine has no
flax."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from watsor_tpu_torch import workload
from watsor_tpu_torch.detection.backend import (FleetBackend,
                                                TorchDetectorBackend)
from watsor_tpu_torch.parallel import FleetDetector, make_mesh
from watsor_tpu_torch.runtime import spans

MODEL = 'efficientdet_lite4'
R50 = 'ssd_resnet50_v1_fpn_1024'
STAGES = ('model.backbone', 'model.fpn', 'model.heads')
BATCH = 64
CAMERAS = ['cam{}'.format(i) for i in range(BATCH)]
# cam0 carries the demo zone mask: first, last, and absent
SENDERS = (CAMERAS, CAMERAS[1:] + CAMERAS[:1], ['cam1'] * BATCH)


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with nvcc')
    return torch.device('cuda', 0)


@pytest.fixture(scope='module')
def lite4(card):
    from watsor_tpu_torch.models.zoo import build_from_zoo
    return build_from_zoo(MODEL, None, seed=0,
                          active_labels=workload.watched_labels(),
                          nms_mode='fused_exact', dtype=torch.bfloat16,
                          device=card)


@pytest.fixture(scope='module')
def r50(card):
    from watsor_tpu_torch.models.zoo import build_from_zoo
    return build_from_zoo(R50, None, seed=0,
                          active_labels=workload.watched_labels(),
                          nms_mode='fused_exact', dtype=torch.bfloat16,
                          device=card)


def _backend(kind, lite4, card):
    """The benchmark's layout: every camera's tables, the first camera's
    zone mask and refiner; ``fleet`` over two shards on the one card."""
    tables, refiners = workload.camera_filters(CAMERAS)
    if kind == 'single':
        return TorchDetectorBackend(lite4, card, camera_tables=tables,
                                    zone_refiners=refiners)
    fleet = FleetDetector(make_mesh(devices=[card, card]), lite4)
    return FleetBackend(fleet, camera_tables=tables, zone_refiners=refiners)


def _frames(seed, size):
    """A batch of seeded uint8 detect planes at the model's size."""
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH, size, size, 3), np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['single', 'fleet'])
def test_dispatch_queues_lite4_without_a_synchronise(lite4, card, kind):
    """Under ``set_sync_debug_mode('error')`` a filtered, zoned batch of 64
    dispatches without a synchronising call; three batches of distinct
    senders dispatched before any is resolved each resolve bit for bit to
    their own synchronous result; and in a traced closed loop that
    resolves each batch right after its dispatch, ``resolve`` finds the
    step still running: ``dispatch`` returned before the forward ended.
    (One batch ahead at this size the forward's launches fill the launch
    queue, so ``dispatch`` returns only once the batch before has ended.)"""
    backend = _backend(kind, lite4, card)
    backend.warmup(batch=BATCH)
    frames = [_frames(seed, lite4.config.input_size) for seed in range(3)]
    want = [backend.detect_batch(f, senders=s)
            for f, s in zip(frames, SENDERS)]
    assert want[0][5].any(), 'the masked camera must hit a zone'
    assert not np.array_equal(want[0][3], want[2][3])
    handles = []
    torch.cuda.set_sync_debug_mode('error')
    try:
        for f, s in zip(frames, SENDERS):
            handles.append(backend.dispatch(f, senders=s))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for expected, handle in zip(want, handles):
        result = backend.resolve(handle)
        for i in (0, 1, 2, 3, 5):                 # all but device_ms
            np.testing.assert_array_equal(result[i], expected[i])

    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for f, s in zip(frames, SENDERS):
            backend.detect_batch(f, senders=s)
    waits = [r.counts['pending'] for r in spans.records()
             if r.name == 'backend.wait']
    assert len(waits) == 3 * (2 if kind == 'fleet' else 1)
    assert max(waits) == 1, waits


@pytest.mark.cuda
def test_r50_stage_spans_time_the_forward_on_the_card(r50, card):
    """Under a profiler capture of CPU and CUDA, a zoned, filtered batch of
    64 dispatches without a synchronising call, its three stage spans
    recording their CUDA events; once resolved, each span's ``device_ns``
    is positive, they follow one another on the stream, and their sum lies
    within the device time from the step's first kernel to its last,
    covering most of the kernels' busy time."""
    backend = _backend('single', r50, card)
    backend.warmup(batch=BATCH)
    frames = _frames(0, r50.config.input_size)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode('error')
        try:
            handle = backend.dispatch(frames, senders=CAMERAS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        backend.resolve(handle)
        torch.cuda.synchronize(card)
    stages = {r.name: r for r in spans.records() if r.name in STAGES}
    assert set(stages) == set(STAGES)
    assert stages['model.heads'].counts == {'levels': 5, 'anchors': 130944}
    device_ns = [stages[name].device_ns for name in STAGES]
    assert all(ns is not None and ns > 0 for ns in device_ns), device_ns
    kernels = [(e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type().name == 'CUDA' and
               not e.is_user_annotation()]
    extent = max(e for _, e in kernels) - min(s for s, _ in kernels)
    busy, reach = 0, None
    for start, end in sorted(kernels):
        start = max(start, reach or start)
        busy += max(end - start, 0)
        reach = max(end, reach or end)
    assert sum(device_ns) <= extent, (device_ns, extent)
    assert sum(device_ns) >= 0.8 * busy, (device_ns, busy)
