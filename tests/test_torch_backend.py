"""The port's device filters and packed transport against the JAX
package's, and TorchDetectorBackend driving the port's ObjectDetector over
the port's FrameBuffers on the CPU.

The filters compare integer-valued SATs and thresholds and the transport
carries exact f32 values, so after ``_unpack_outputs`` both packages must
agree bit for bit, zone bits included."""

import time
from queue import Queue

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from watsor_tpu.detection.backend import _get_packers
from watsor_tpu.detection.backend import _unpack_outputs as j_unpack
from watsor_tpu.filters.mask import ZoneMask as JZoneMask
from watsor_tpu.ops import filter_device as j_filter
from watsor_tpu_torch.config.coco import coco_label_index
from watsor_tpu_torch.detection.backend import (TorchDetectorBackend,
                                                _unpack_outputs, pack_outputs)
from watsor_tpu_torch.detection.detector import ObjectDetector
from watsor_tpu_torch.filters.mask import ZoneMask
from watsor_tpu_torch.runtime.frames import MAX_ZONES, FrameBuffer, State
from watsor_tpu_torch.runtime.tasks import Payload
from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
from watsor_tpu_torch.ops import filter_device as t_filter

LABELS = [coco_label_index(n) for n in ('person', 'car', 'truck', 'dog')]
DETECT_A = [{'person': {'confidence': 30, 'area': 1, 'zones': [2]}},
            {'car': {'confidence': 50, 'area': 0.5, 'zones': []}}]
DETECT_B = [{'truck': {'confidence': 20, 'area': 2}},
            {'person': None}]


def _zone_mask(mask_class=ZoneMask):
    alpha = np.zeros((120, 160), np.uint8)
    alpha[5:60, 5:80] = 255
    alpha[60:115, 70:155] = 255
    return mask_class(alpha, (120, 160, 3))


def _camera_tables(module):
    """Each package's tables from its own ZoneMask."""
    mask_class = JZoneMask if module is j_filter else ZoneMask
    out = {}
    for name, detect, mask in (('a', DETECT_A, _zone_mask(mask_class)),
                               ('b', DETECT_B, None)):
        conf, area = module.threshold_tables(detect)
        zs, za = module.zone_tables(mask, detect)
        out[name] = (conf, area, zs, za)
    return out


def _detections(seed, B=4, N=100):
    rng = np.random.default_rng(seed)
    yx = rng.uniform(0, 0.8, (B, N, 2))
    hw = rng.uniform(0.01, 0.5, (B, N, 2))
    boxes = np.clip(np.concatenate([yx, yx + hw], -1), 0, 1) \
        .astype(np.float32)
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    classes = rng.choice(LABELS + [0], (B, N)).astype(np.int32)
    return boxes, scores, classes


@pytest.mark.parametrize('seed', [0, 1])
def test_filters_and_packed_transport_match_jax(seed):
    boxes, scores, classes = _detections(seed)
    names = sorted(_camera_tables(t_filter))
    row_idx = np.array([0, 1, 1, 0], np.int32)       # cameras a, b, b, a

    j_tables = _camera_tables(j_filter)
    j_stack = [jnp.asarray(np.stack([j_tables[n][i] for n in names]))
               for i in range(4)]
    js, jc, jz, jv = j_filter.apply_filters_device_indexed(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        *j_stack, jnp.asarray(row_idx))
    _, pack_zones = _get_packers()
    want = np.asarray(pack_zones(jnp.asarray(boxes), js, jc, jv, jz))

    t_tables = _camera_tables(t_filter)
    t_stack = [torch.from_numpy(np.stack([t_tables[n][i] for n in names]))
               for i in range(4)]
    ts, tc, tz, tv = t_filter.apply_filters_device_indexed(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes), *t_stack, torch.from_numpy(row_idx))
    got = pack_outputs(torch.from_numpy(boxes), ts, tc, tv, tz).numpy()

    assert int(np.asarray(jv).sum()) > 0
    assert np.asarray(jz).any(), 'the zone bits must be exercised'
    np.testing.assert_array_equal(got, want)
    for g, w in zip(_unpack_outputs(got, 3, True, MAX_ZONES),
                    j_unpack(want, 3, True, MAX_ZONES)):
        np.testing.assert_array_equal(g, w)


def test_plain_packed_transport_matches_jax():
    boxes, scores, classes = _detections(2)
    valid = (scores > 0.5).sum(-1).astype(np.int32)
    pack, _ = _get_packers()
    want = np.asarray(pack(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(classes), jnp.asarray(valid)))
    got = pack_outputs(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(classes),
                       torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_filter_table_rows_match_jax():
    """The port's table store lays cameras out and ships row indices as
    the JAX package's does, padding rows included."""
    from watsor_tpu.detection.backend import _FilterTableStore as JaxStore
    from watsor_tpu_torch.detection.backend import _FilterTableStore
    tables = _camera_tables(t_filter)
    port, jax_store = _FilterTableStore(tables, 'cpu'), JaxStore(tables)
    assert port.names == jax_store.names
    for senders, b in ((['b', 'a', 'b'], 4), (['a'], 1), (['b'] * 5, 4)):
        np.testing.assert_array_equal(port.rows(senders, b),
                                      jax_store.rows(senders, b))
    for got, want in zip(port.tables, jax_store.tables):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_refuses_more_than_24_zone_bits():
    hits = torch.zeros((1, 2, 25), dtype=torch.bool)
    with pytest.raises(ValueError, match='24'):
        pack_outputs(torch.zeros(1, 2, 4), torch.zeros(1, 2),
                     torch.zeros(1, 2, dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32), hits)


@pytest.fixture(scope='module')
def small_detector():
    cfg = SSDConfig(num_classes=90, input_size=96, dtype=torch.float32,
                    nms_mode='fused_exact', active_labels=(1, 3),
                    score_threshold=0.0)
    return build_detector(cfg, seed=0)


def test_object_detector_confirms_every_frame(small_detector):
    """ObjectDetector + TorchDetectorBackend(device='cpu') over FrameBuffers
    of two cameras with device filters: every pushed frame leaves DETECT
    and the filtered detections land in its header."""
    tables = _camera_tables(t_filter)
    refiners = {'a': t_filter.ZoneRefiner(_zone_mask(), DETECT_A)}
    backend = TorchDetectorBackend(small_detector, 'cpu',
                                   camera_tables=tables,
                                   zone_refiners=refiners)
    assert backend.device_name == 'CPU 0'
    buffers = {name: FrameBuffer(4, 160, 120, detect_hw=(96, 96))
               for name in ('a', 'b')}
    rng = np.random.default_rng(3)
    queue = Queue()
    detector = ObjectDetector('det', queue, buffers, backend, max_batch=2,
                              batch_window_ms=2.0)
    detector.start()
    frames = []
    try:
        assert detector.ready.wait(120)
        for index in range(4):
            for name, buffer in buffers.items():
                frame = buffer.frames[index]
                frame.detect_plane[:] = rng.integers(0, 256, (96, 96, 3),
                                                     np.uint8)
                frame.clear()
                frame.stamp()
                frame.latch.next()                 # READY -> DETECT
                queue.put(Payload(name, index))
                frames.append((name, frame))
        deadline = time.time() + 120
        while time.time() < deadline and any(
                f.latch.state == State.DETECT for _, f in frames):
            time.sleep(0.01)
    finally:
        detector.terminate()
        detector.join(30)
    assert all(f.latch.state == State.PUBLISH for _, f in frames)
    written = 0
    for name, frame in frames:
        records = frame.detections_view()
        written += len(records)
        watched = {coco_label_index('person'), coco_label_index('car')} \
            if name == 'a' else {coco_label_index('person'),
                                 coco_label_index('truck')}
        assert set(records['label'].tolist()) <= watched
        assert (records['confidence'] > 0).all()
    assert written > 0


def test_backend_pads_to_the_bucket_and_slices_back(small_detector):
    backend = TorchDetectorBackend(small_detector, 'cpu')
    images = np.random.default_rng(4).integers(0, 256, (3, 96, 96, 3),
                                               np.uint8)
    boxes, scores, classes, valid, ms = backend.detect_batch(images)
    assert boxes.shape == (3, 100, 4) and valid.shape == (3,)
    padded = np.zeros((4, 96, 96, 3), np.uint8)    # bucket(3) == 4
    padded[:3] = images
    direct = small_detector.detect_batch(torch.from_numpy(padded))
    np.testing.assert_array_equal(valid, direct.valid.numpy()[:3])
    np.testing.assert_array_equal(classes, direct.classes.numpy()[:3])
    np.testing.assert_array_equal(boxes, direct.boxes.numpy()[:3])
