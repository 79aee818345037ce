"""The port's fleet (parallel/mesh.py, parallel/fleet.py, FleetBackend) on
the CPU, over a mesh that repeats the CPU so the batch really splits into
shards, against the JAX package's ``detect_batch`` and the port's single
TorchDetectorBackend on the same weights and frames.

Bars (f32): boxes within 1e-5 of the JAX package's, classes and valid
equal (tests/test_fleet.py:141-159); against the port's single backend,
bit for bit (both run the same replica on the same rows)."""

import threading
import time
from queue import Queue

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.models.efficientdet import EfficientDet as JaxEfficientDet
from watsor_tpu.models.efficientdet import build_effdet as jax_build_effdet
from watsor_tpu.models.efficientdet import lite_config as jax_lite_config
from watsor_tpu.models.ssd import SSD as JaxSSD
from watsor_tpu.models.ssd import SSDConfig as JaxSSDConfig
from watsor_tpu.models.ssd import build_detector as jax_build_ssd
from watsor_tpu_torch.detection import FleetBackend, TorchDetectorBackend
from watsor_tpu_torch.detection.detector import ObjectDetector
from watsor_tpu_torch.filters.mask import ZoneMask
from watsor_tpu_torch.models.efficientdet import build_effdet, lite_config
from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
from watsor_tpu_torch.ops import filter_device
from watsor_tpu_torch.parallel import (FleetDetector, batch_sharding,
                                       make_mesh, replicate)
from watsor_tpu_torch.runtime.frames import FrameBuffer, State
from watsor_tpu_torch.runtime.tasks import Payload
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

BOX_TOL = 1e-5
SIZE = 96
TINY = dict(num_classes=3, input_size=SIZE, width_multiplier=0.35,
            extra_features=(32, 32, 32, 32), nms_mode='fused_exact')
EFFDET = dict(num_classes=3, input_size=128, fpn_channels=16, fpn_repeats=1,
              head_repeats=1, nms_mode='fused_exact')


def _jax_tree(jax_det):
    return jax.tree_util.tree_map(np.asarray, jax_det.params)


def _pair(module, jax_cfg, jax_build, cfg, build):
    """(JAX detector, the port's) on the JAX PRNGKey(0) tree (the init of
    the JAX build functions, compiled)."""
    dummy = jnp.zeros((1, cfg.input_size, cfg.input_size, 3), jnp.float32)
    init = jax.jit(module(jax_cfg).init)(jax.random.PRNGKey(0), dummy)
    jax_det = jax_build(jax_cfg, params=init)
    return jax_det, build(cfg, variables=_jax_tree(jax_det), device='cpu')


@pytest.fixture(scope='module')
def ssd_pair():
    return _pair(JaxSSD, JaxSSDConfig(dtype=jnp.float32, **TINY),
                 jax_build_ssd, SSDConfig(dtype=torch.float32, **TINY),
                 build_detector)


@pytest.fixture(scope='module')
def effdet_pair():
    return _pair(JaxEfficientDet,
                 jax_lite_config('lite0', dtype=jnp.float32, **EFFDET),
                 jax_build_effdet,
                 lite_config('lite0', dtype=torch.float32, **EFFDET),
                 build_effdet)


def _frames(seed, n, size):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


def _concat(outs):
    return [torch.cat([getattr(o, f) for o in outs]).numpy()
            for f in ('boxes', 'scores', 'classes', 'valid')]


@pytest.mark.parametrize('family', ['ssd', 'effdet'])
def test_fleet_detect_matches_jax_and_the_single_backend(
        family, ssd_pair, effdet_pair):
    jax_det, port = ssd_pair if family == 'ssd' else effdet_pair
    size = port.config.input_size
    frames = _frames(5, 4, size)
    fleet = FleetDetector(make_mesh(devices=['cpu', 'cpu']), port)
    outs = fleet.detect(frames)
    assert [o.boxes.shape[0] for o in outs] == [2, 2]
    got = _concat(outs)
    want = [np.asarray(a) for a in jax_det.detect_batch(
        jax_det.params, jnp.asarray(frames))]
    assert int(want[3].sum()) > 0, 'the frames must give detections'
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_TOL)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    # each shard equals the port's single backend on that shard's frames
    single = TorchDetectorBackend(port, 'cpu')
    for i, shard in enumerate(batch_sharding(fleet.mesh, frames)):
        boxes, scores, classes, valid, _ = single.detect_batch(shard)
        np.testing.assert_array_equal(outs[i].boxes.numpy(), boxes)
        np.testing.assert_array_equal(outs[i].scores.numpy(), scores)
        np.testing.assert_array_equal(outs[i].classes.numpy(), classes)
        np.testing.assert_array_equal(outs[i].valid.numpy(), valid)


@pytest.mark.parametrize('family', ['ssd', 'effdet'])
def test_fleet_backend_on_rebuilt_replicas_matches_jax(family, ssd_pair,
                                                       effdet_pair):
    """FleetBackend.detect_batch, the service's path, over a mesh whose first
    device ('cpu:0') is not the adopted detector's ('cpu'): that shard runs
    on a replica rebuilt from the adopted weights. The result equals the
    JAX package's detect_batch at the bars above and the single backend's
    bit for bit."""
    jax_det, port = ssd_pair if family == 'ssd' else effdet_pair
    mesh = make_mesh(devices=['cpu:0', 'cpu'])
    fleet = FleetDetector(mesh, port)
    assert fleet.replicas[0] is not port and fleet.replicas[1] is port
    assert fleet.replicas[0].device == torch.device('cpu', 0)
    frames = _frames(5, 4, port.config.input_size)
    got = FleetBackend(fleet).detect_batch(frames)
    want = [np.asarray(a) for a in jax_det.detect_batch(
        jax_det.params, jnp.asarray(frames))]
    assert int(want[3].sum()) > 0, 'the frames must give detections'
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_TOL)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    single = TorchDetectorBackend(port, 'cpu').detect_batch(frames)
    for g, w in zip(got[:4], single[:4]):
        np.testing.assert_array_equal(g, w)


class _ShardRecorder:
    """Wraps a detector's detect_batch to record each shard's rows."""

    def __init__(self, fleet):
        self.rows = []
        for i, replica in enumerate(fleet.replicas):
            fleet.replicas[i] = replica._replace(
                detect_batch=self._wrap(replica.detect_batch))

    def _wrap(self, fn):
        def detect_batch(x):
            self.rows.append(x.shape[0])
            return fn(x)
        return detect_batch


@pytest.mark.parametrize('n,shards', [(1, [1, 1, 1]), (5, [3, 3, 3]),
                                      (3, [2, 2, 2])])
def test_fleet_backend_pads_to_the_data_size_and_truncates(ssd_pair, n,
                                                           shards):
    """bucket(n), at least the data size, rounded up to a multiple of it:
    1 -> 3, 5 -> 8 -> 9, 3 -> 4 -> 6; the result is cut back to n rows
    equal to the single backend's."""
    _, port = ssd_pair
    fleet = FleetDetector(make_mesh(devices=['cpu'] * 3), port)
    recorder = _ShardRecorder(fleet)
    backend = FleetBackend(fleet)
    frames = _frames(6, n, SIZE)
    got = backend.detect_batch(frames)
    assert recorder.rows == shards
    want = TorchDetectorBackend(port, 'cpu').detect_batch(frames)
    assert got[0].shape == (n, 100, 4) and got[3].shape == (n,)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] > 0


DETECT = [{'person': {'confidence': 10, 'area': 1, 'zones': [1]}},
          {'car': {'confidence': 10, 'area': 1}}]


def _tables():
    """Camera 'a' with a zone mask (and its exact host refiner), 'b'
    without."""
    alpha = np.zeros((120, 160), np.uint8)
    alpha[5:60, 5:80] = 255
    mask = ZoneMask(alpha, (120, 160, 3))
    tables, refiners = {}, {}
    for name, zone_mask in (('a', mask), ('b', None)):
        conf, area = filter_device.threshold_tables(DETECT)
        zs, za = filter_device.zone_tables(zone_mask, DETECT)
        tables[name] = (conf, area, zs, za)
    refiners['a'] = filter_device.ZoneRefiner(mask, DETECT)
    return tables, refiners


@pytest.fixture(scope='module')
def watched_detector(ssd_pair):
    """The tiny SSD watching person and car at a zero score threshold, so
    the filters see many candidates."""
    jax_det, _ = ssd_pair
    cfg = SSDConfig(dtype=torch.float32, **TINY)._replace(
        num_classes=3, active_labels=(1, 3), score_threshold=0.0)
    return build_detector(cfg, variables=_jax_tree(jax_det), device='cpu')


def test_fleet_backend_filters_like_the_single_backend(watched_detector):
    """Over two devices ('cpu:0' and 'cpu'), each with its own copy of the
    camera tables and its own replica."""
    tables, refiners = _tables()
    fleet = FleetDetector(make_mesh(devices=['cpu:0', 'cpu']),
                          watched_detector)
    backend = FleetBackend(fleet, camera_tables=tables,
                           zone_refiners=refiners)
    assert len(backend._table_stores) == 2
    single = TorchDetectorBackend(watched_detector, 'cpu',
                                  camera_tables=tables,
                                  zone_refiners=refiners)
    assert backend.device_name == 'CPU MESH {data: 2}'
    frames = _frames(7, 3, SIZE)
    senders = ['a', 'b', 'a']
    got = backend.detect_batch(frames, senders=senders)
    want = single.detect_batch(frames, senders=senders)
    assert len(got) == len(want) == 6
    assert int((got[1] > 0).sum()) > 0
    assert got[5].any(), 'the zone hits must be exercised'
    for i in (0, 1, 2, 3, 5):
        np.testing.assert_array_equal(got[i], want[i])


def test_fleet_backend_warms_the_filtered_step(watched_detector):
    tables, _ = _tables()
    fleet = FleetDetector(make_mesh(devices=['cpu', 'cpu']),
                          watched_detector)
    recorder = _ShardRecorder(fleet)
    backend = FleetBackend(fleet, camera_tables=tables)
    seen = []
    dispatch = backend.dispatch

    def spy(images, senders=None):
        seen.append((images.shape[0], senders))
        return dispatch(images, senders=senders)

    backend.dispatch = spy
    backend.warmup(batch=3)
    assert seen == [(4, ['a'] * 4)] and recorder.rows == [2, 2]


def test_fleet_backend_drives_an_object_detector(ssd_pair):
    """FleetBackend inside the port's ObjectDetector over FrameBuffers of
    two cameras: every pushed frame leaves DETECT
    (tests/test_fleet.py:60,69)."""
    _, port = ssd_pair
    fleet = FleetDetector(make_mesh(devices=['cpu', 'cpu']), port)
    buffers = {name: FrameBuffer(3, 160, 120, detect_hw=(SIZE, SIZE))
               for name in ('cam1', 'cam2')}
    queue = Queue()
    stop = threading.Event()
    detector = ObjectDetector('det-fleet', queue, buffers,
                              FleetBackend(fleet), stop_event=stop,
                              max_batch=4, batch_window_ms=2.0)
    assert detector.device_name == 'CPU MESH {data: 2}'
    rng = np.random.default_rng(8)
    frames = []
    detector.start()
    try:
        assert detector.ready.wait(60)
        for index in range(3):
            for name, buffer in buffers.items():
                frame = buffer.frames[index]
                frame.detect_plane[:] = rng.integers(0, 256, (SIZE, SIZE, 3),
                                                     np.uint8)
                frame.clear()
                frame.stamp()
                frame.latch.next()                 # READY -> DETECT
                queue.put(Payload(name, index))
                frames.append(frame)
        deadline = time.time() + 60
        while time.time() < deadline and any(
                f.latch.state == State.DETECT for f in frames):
            time.sleep(0.01)
    finally:
        stop.set()
        detector.join(30)
    assert not detector.is_alive()
    assert all(f.latch.state == State.PUBLISH for f in frames)


def _raw(detector, seed=9):
    x = torch.from_numpy(_frames(seed, 2, detector.config.input_size)) \
        .float() * (2.0 / 255.0) - 1.0
    with torch.inference_mode():
        return [a.numpy() for a in detector.raw_apply(x)]


def _state(detector):
    return {k: v.numpy() for k, v in detector.model.state_dict().items()
            if v.device.type != 'meta'}


@pytest.mark.parametrize('kind', ['plain', 'fused', 'int8_weights',
                                  'effdet'])
def test_replicas_hold_the_adopted_weights_bit_for_bit(
        kind, ssd_pair, effdet_pair):
    """``replicate`` on another device rebuilds from the adopted weights:
    here rebuilt on the CPU again, its weights and raw outputs equal the
    adopted detector's bit for bit; on the adopted device it is the
    detector itself."""
    from watsor_tpu_torch.models.quantize import build_quantized_detector
    from watsor_tpu_torch.models.ssd_fused import build_fused_detector
    _, port = effdet_pair if kind == 'effdet' else ssd_pair
    if kind == 'fused':
        full = SSDConfig(dtype=torch.float32, num_classes=3, input_size=SIZE,
                         extra_features=(32, 32, 32, 32))
        port = build_fused_detector(build_detector(full, device='cpu'))
    elif kind == 'int8_weights':
        port = build_quantized_detector(port.config, port.variables,
                                        anchors=port.anchors, device='cpu')
    assert replicate(port, 'cpu') is port
    twin = port.rebuild(torch.device('cpu'))
    assert twin is not port and twin.config == port.config
    if port.model is not None:
        mine, theirs = _state(port), _state(twin)
        assert mine.keys() == theirs.keys() and mine
        for key in mine:
            np.testing.assert_array_equal(mine[key], theirs[key])
    for got, want in zip(_raw(twin), _raw(port)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twin.anchors, port.anchors)


def test_mesh_spans_the_device_pool(monkeypatch):
    monkeypatch.setenv('WATSOR_DEVICE_POOL', 'cpu:1')
    mesh = make_mesh()
    assert mesh.devices == (torch.device('cpu'),)
    assert mesh.shape == {'data': 1, 'model': 1}
    if not torch.cuda.is_available():
        monkeypatch.delenv('WATSOR_DEVICE_POOL')
        with pytest.raises(RuntimeError, match='No CUDA device'):
            make_mesh()
    two = make_mesh(devices=['cpu', 'cpu'])
    assert two.shape['data'] == 2
    # devices are kept as given, in order: 'cpu:0' is not 'cpu'
    assert make_mesh(devices=['cpu:0', 'cpu']).devices == \
        (torch.device('cpu', 0), torch.device('cpu'))


def test_mesh_lays_a_data_by_model_grid():
    """Row-major as watsor_tpu/parallel/mesh.py:27-40 lays it: row i is
    data shard i, its devices the shard's model group."""
    devices = ['cpu:0', 'cpu'] * 3
    mesh = make_mesh(devices=devices, model_parallel=2)
    assert mesh.shape == {'data': 3, 'model': 2}
    assert mesh.rows == ((torch.device('cpu', 0), torch.device('cpu')),) * 3
    assert mesh.data_devices == (torch.device('cpu', 0),) * 3
    assert make_mesh(devices=devices, model_parallel=3).rows == \
        ((torch.device('cpu', 0), torch.device('cpu'),
          torch.device('cpu', 0)),
         (torch.device('cpu'), torch.device('cpu', 0), torch.device('cpu')))


@pytest.mark.parametrize('n,model_parallel', [(3, 2), (4, 3), (2, 0)])
def test_mesh_raises_on_a_model_size_that_does_not_divide(n, model_parallel):
    with pytest.raises(ValueError, match='not divisible'):
        make_mesh(model_parallel=model_parallel, devices=['cpu'] * n)


def test_mesh_takes_the_first_n_devices(monkeypatch):
    devices = ['cpu:0', 'cpu', 'cpu:0', 'cpu']
    assert make_mesh(3, devices=devices).devices == \
        (torch.device('cpu', 0), torch.device('cpu'), torch.device('cpu', 0))
    assert make_mesh(2, 2, devices).shape == {'data': 1, 'model': 2}
    assert make_mesh(8, devices=devices).shape['data'] == 4
    monkeypatch.setenv('WATSOR_DEVICE_POOL', 'cpu:1')
    assert make_mesh(1).devices == (torch.device('cpu'),)


@pytest.mark.parametrize('kind', ['plain', 'fused'])
def test_model_axis_fleet_matches_jax_and_the_data_only_fleet(
        ssd_pair, monkeypatch, kind):
    """FleetDetector at (data 2, model 2) on the CPU: each row's replica
    runs its head kernels split over the row's model group (12 split heads
    a shard: at 96x96 every head's channels are even), against the port's
    data-only fleet over the same rows (bit for bit on the CPU) and, for
    the plain walk, JAX's FleetDetector over make_mesh(8, model_parallel=2)
    at the bars above; the fused walk at width 1.0."""
    from watsor_tpu.parallel.fleet import FleetDetector as JaxFleetDetector
    from watsor_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from watsor_tpu_torch.models.ssd_fused import build_fused_detector
    from watsor_tpu_torch.parallel.heads import SplitHead
    jax_det, port = ssd_pair
    if kind == 'fused':
        port = build_fused_detector(build_detector(SSDConfig(
            dtype=torch.float32, num_classes=3, input_size=SIZE,
            extra_features=(32, 32, 32, 32), nms_mode='fused_exact'),
            device='cpu'))
    calls = []
    run = SplitHead.__call__
    monkeypatch.setattr(SplitHead, '__call__',
                        lambda self, x: calls.append(x.shape) or run(self, x))
    frames = _frames(11, 4, SIZE)
    fleet = FleetDetector(make_mesh(devices=['cpu:0', 'cpu'] * 2,
                                    model_parallel=2), port)
    assert fleet.replicas[0] is fleet.replicas[1]
    assert fleet.replicas[0] is not port
    assert fleet.devices == (torch.device('cpu', 0),) * 2
    got = _concat(fleet.detect(frames))
    assert len(calls) == 2 * 12
    data_only = _concat(FleetDetector(make_mesh(devices=['cpu:0'] * 2),
                                      port).detect(frames))
    for g, w in zip(got, data_only):
        np.testing.assert_array_equal(g, w)
    assert int(got[3].sum()) > 0, 'the frames must give detections'
    backend = FleetBackend(fleet)
    assert backend.device_name == 'CPU MESH {data: 2, model: 2}'
    np.testing.assert_array_equal(backend.detect_batch(frames)[0], got[0])
    if kind == 'fused':
        return
    jax_fleet = JaxFleetDetector(jax_make_mesh(8, model_parallel=2),
                                 jax_det.config, detector=jax_det)
    want = [np.asarray(a) for a in jax_fleet.detect(jnp.asarray(frames))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_TOL)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_model_axis_fleet_of_other_walks(ssd_pair, effdet_pair):
    """Over a model axis of two: EfficientDet has no kernel the rule splits
    and runs data-parallel, equal to the data-only fleet; so does a
    weight-only int8 detector, whose kernels are QuantizedLeaf values, as
    the JAX package's rule leaves them whole. Its adopted replica serves
    the mesh's rows itself, as it does with ``model_parallel=False``."""
    from watsor_tpu_torch.models.quantize import build_quantized_detector
    mesh = make_mesh(devices=['cpu'] * 4, model_parallel=2)
    _, ssd = ssd_pair
    int8 = build_quantized_detector(ssd.config, ssd.variables,
                                    anchors=ssd.anchors, device='cpu')
    for port in (effdet_pair[1], int8):
        frames = _frames(12, 4, port.config.input_size)
        got = _concat(FleetDetector(mesh, port).detect(frames))
        want = _concat(FleetDetector(make_mesh(devices=['cpu'] * 2),
                                     port).detect(frames))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert FleetDetector(mesh, int8).replicas[0] is int8
    assert FleetDetector(mesh, int8, model_parallel=False).replicas[0] \
        is int8


@pytest.fixture(scope='module')
def int8_pair():
    """(JAX detector, the port's, calibration frames, the JAX absmax) of the
    width-1.0 SSD-MobileNetV2 the int8 walk covers, at 96x96, 2 classes
    (cls_head0's 9 channels stay whole at model 2, as the production
    273-channel head does), f32, ``nms: exact``."""
    from watsor_tpu.models import ssd_int8 as j_int8
    cfg = dict(num_classes=2, input_size=SIZE, nms_mode='exact')
    jax_det, port = _pair(JaxSSD, JaxSSDConfig(dtype=jnp.float32, **cfg),
                          jax_build_ssd, SSDConfig(dtype=torch.float32, **cfg),
                          build_detector)
    calib = _frames(13, 4, SIZE)
    return jax_det, port, calib, j_int8.calibrate(jax_det, calib)


@pytest.mark.parametrize('mode', ['int8', 'int8_full'])
def test_model_axis_fleet_of_int8_walks(mode, int8_pair, monkeypatch):
    """Both int8 modes behind FleetDetector at (data 2, model 2), as the
    JAX package runs them: weight-only int8 splits nothing; int8_full
    splits its float head kernels whose channels divide the model axis
    (11 of 12), each slice the dtype-rounded kernel in f32. Each equals
    the port's data-only fleet bit for bit and the JAX FleetDetector over
    make_mesh(8, model_parallel=2) at the int8 walk's bars
    (tests/test_torch_int8.py: valid counts and labels equal, boxes and
    scores within 5e-3; weight-only int8 at the float fleet's)."""
    from watsor_tpu.models import quantize as j_quant
    from watsor_tpu.models import ssd_int8 as j_int8
    from watsor_tpu.parallel.fleet import FleetDetector as JaxFleetDetector
    from watsor_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from watsor_tpu_torch.models.quantize import build_quantized_detector
    from watsor_tpu_torch.models.ssd_int8 import build_int8_detector
    from watsor_tpu_torch.parallel.heads import SplitHead
    jax_det, port, calib, absmax = int8_pair
    if mode == 'int8':
        jax_q = j_quant.build_quantized_detector(jax_det.config,
                                                 params=jax_det.params)
        port_q = build_quantized_detector(port.config, port.variables,
                                          anchors=port.anchors, device='cpu')
        tol = BOX_TOL
    else:
        monkeypatch.setattr(j_int8, 'calibrate', lambda *args, **kw: absmax)
        jax_q = j_int8.build_int8_detector(jax_det, calib)
        port_q = build_int8_detector(port, calib, absmax=absmax)
        tol = 5e-3
    calls = []
    run = SplitHead.__call__
    monkeypatch.setattr(SplitHead, '__call__',
                        lambda self, x: calls.append(x.shape) or run(self, x))
    frames = _frames(14, 4, SIZE)
    fleet = FleetDetector(make_mesh(devices=['cpu:0', 'cpu'] * 2,
                                    model_parallel=2), port_q)
    got = _concat(fleet.detect(frames))
    assert len(calls) == (0 if mode == 'int8' else 2 * 11)
    data_only = _concat(FleetDetector(make_mesh(devices=['cpu:0'] * 2),
                                      port_q).detect(frames))
    for g, w in zip(got, data_only):
        np.testing.assert_array_equal(g, w)
    jax_fleet = JaxFleetDetector(jax_make_mesh(8, model_parallel=2),
                                 jax_q.config, detector=jax_q)
    want = [np.asarray(a) for a in jax_fleet.detect(jnp.asarray(frames))]
    assert int(want[3].sum()) > 0, 'the frames must give detections'
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol)


def test_batch_sharding_splits_into_equal_contiguous_shards():
    mesh = make_mesh(devices=['cpu'] * 3)
    batch = np.arange(6 * 2).reshape(6, 2)
    shards = batch_sharding(mesh, batch)
    assert [s.tolist() for s in shards] == [batch[0:2].tolist(),
                                           batch[2:4].tolist(),
                                           batch[4:6].tolist()]
    with pytest.raises(ValueError, match='does not split'):
        batch_sharding(mesh, batch[:5])
