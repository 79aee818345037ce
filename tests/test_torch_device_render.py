"""The port's batched device renderer (output/device_render.py) on the
CPU: concurrent camera threads batch into one render step, and each
result equals ops/overlay.render_detections on that frame alone; the
effect draws into the out frame; failures and timeouts pass frames
through and are counted (mirroring tests/test_device_render.py)."""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from watsor_tpu_torch.config.coco import coco_label_index
from watsor_tpu_torch.ops.overlay import render_detections
from watsor_tpu_torch.output import device_render
from watsor_tpu_torch.output.device_render import (DeviceDrawEffect,
                                                   DeviceRenderer)
from watsor_tpu_torch.runtime.frames import DETECTION_DTYPE, FrameBuffer

PERSON = coco_label_index('person')


@pytest.fixture
def renderer():
    r = DeviceRenderer(window_ms=50, max_batch=8, device='cpu')
    yield r
    r.close()
    assert not any(t.is_alive() for t in r._threads.values())


def _request(tid):
    rng = np.random.default_rng(tid)
    image = rng.integers(0, 256, (32, 40, 3), np.uint8)
    boxes = np.array([[4 + tid, 4, 24 + tid, 24], [10, 8 + tid, 30, 36],
                      [-3, 30, 12, 50]], np.float32)
    classes = np.array([PERSON, 3, 18], np.int32)
    return image, boxes, classes


def _alone(image, boxes, classes):
    return render_detections(torch.from_numpy(image[None]),
                             torch.from_numpy(boxes[None]),
                             torch.from_numpy(classes[None]))[0].numpy()


def test_concurrent_requests_render_independently(renderer):
    results = {}
    barrier = threading.Barrier(4)

    def submit(tid):
        image, boxes, classes = _request(tid)
        barrier.wait(5)
        results[tid] = renderer.render(image, boxes, classes)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == [0, 1, 2, 3]
    for tid, out in results.items():
        image, boxes, classes = _request(tid)
        assert out.shape == (32, 40, 3)
        assert (out != image).any(), 'no border for request %d' % tid
        np.testing.assert_array_equal(out, _alone(image, boxes, classes))
    assert renderer.frames == 4 and renderer.batches < 4, \
        'concurrent requests must share a batch'
    assert renderer.failures == renderer.timeouts == 0


def test_effect_draws_into_out_frame(renderer):
    buffer = FrameBuffer(2, 48, 32)
    frame_in, frame_out = buffer.frames[0], buffer.frames[1]
    records = np.zeros(1, DETECTION_DTYPE)
    records[0]['label'] = PERSON
    records[0]['confidence'] = 0.87
    records[0]['bbox'] = (6, 6, 26, 40)
    frame_out.set_detections(records)
    frame_out.image[:] = 0

    effect = DeviceDrawEffect(renderer, draw_labels=False)
    effect.apply(frame_in, frame_out)
    assert frame_out.image[6, 20].sum() > 0, 'border missing'
    assert frame_out.image[16, 20].sum() == 0, 'interior painted'
    assert renderer.batches == 1


def test_no_detections_is_noop(renderer):
    buffer = FrameBuffer(2, 48, 32)
    frame_in, frame_out = buffer.frames[0], buffer.frames[1]
    frame_out.image[:] = 7
    DeviceDrawEffect(renderer).apply(frame_in, frame_out)
    assert (frame_out.image == 7).all()
    assert renderer.batches == 0


def test_default_device_needs_a_card(monkeypatch):
    """DeviceRenderer() is on the current CUDA device; with none visible
    it raises, naming device='cpu', and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceRenderer()


def test_a_failed_render_is_logged_counted_and_passed_through(
        renderer, monkeypatch, caplog):
    def broken(*args, **kwargs):
        raise RuntimeError('render exploded')

    monkeypatch.setattr(device_render, 'render_boxes', broken)
    image, boxes, classes = _request(0)
    with caplog.at_level(logging.ERROR, logger='watsor_tpu_torch.render'):
        out = renderer.render(image, boxes, classes)
    assert out is image
    assert renderer.failures == 1 and renderer.batches == 0
    record, = [r for r in caplog.records if r.levelno == logging.ERROR]
    assert record.exc_info and 'render exploded' in str(record.exc_info[1])


def test_a_timeout_passes_the_frame_through_and_is_counted(
        renderer, monkeypatch):
    release = threading.Event()
    render_boxes = device_render.render_boxes

    def slow(*args, **kwargs):
        release.wait(5)
        return render_boxes(*args, **kwargs)

    monkeypatch.setattr(device_render, 'render_boxes', slow)
    image, boxes, classes = _request(1)
    start = time.monotonic()
    out = renderer.render(image, boxes, classes, timeout=0.1)
    assert out is image and time.monotonic() - start < 5
    assert renderer.timeouts == 1
    release.set()
    deadline = time.monotonic() + 5
    while renderer.batches < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert renderer.batches == 1 and renderer.failures == 0
