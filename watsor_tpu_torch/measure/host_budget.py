"""The host's cost a frame by stage (counterpart of scripts/host_budget.py).

Each host stage of the serving path runs alone, in this thread, on the
port's own copies of the host layers, with 1080p inputs and 5 detections a
frame (the stages and their inputs are the script's):

  sieve_tracker        DetectionSieve with the device filters on (tracker only)
  sieve_host_cascade   DetectionSieve with the host cascade (confidence,
                       area, the two-zone mask), as WATSOR_DEVICE_FILTERS=0
  detector_stage       the staging copy of one 300x300 detect plane
  detector_scatter     ObjectDetector._scatter a frame (zones path), fed
                       the packed step's result tuple
  snapshot_steady      Snapshot._new_frame, steady state (no image copy)
  snapshot_copy        Snapshot._new_frame under a rising sub-epsilon
                       confidence
  mqtt_states          MQTT._new_frame over a real socket to the port's
                       testing/broker.py
  mqtt_details         the same with the per-detection details on
  jpeg_1080p           JPEG encode of one 1080p noise frame; then the
                       viewer variants on a camera-like scene

``per_frame`` is the steady serving path (tracker, stage, scatter,
snapshot, MQTT states) and ``cameras_per_core_at_30fps`` what one core
keeps at 30 frames/s a camera. No kernel runs here; ``device`` only labels
the record. The record is written to HOST_BUDGET_OUT where that is set (the
script writes HOST_BUDGET.json by default; this module never does).
"""

import os
import time
from queue import Queue

import numpy as np

from watsor_tpu_torch.measure import write_out
from watsor_tpu_torch.runtime.frames import DETECTION_DTYPE, FrameBuffer

W, H = 1920, 1080
N_DET = 5
FPS = 30.0
# repetitions of each stage (scripts/host_budget.py's counts)
REPS = {'sieve': 400, 'detector_stage': 2000, 'detector_scatter': 200,
        'snapshot_steady': 400, 'snapshot_copy': 60, 'mqtt': 400,
        'jpeg_1080p': 30, 'jpeg_viewer': 60}


class _NoopLatch:
    state = None

    def next(self):
        pass


# copied from scripts/host_budget.py:55-66
def _detections(rng, t=0):
    """5 plausible moving detections (person/car) in 1080p pixel space."""
    recs = np.zeros(N_DET, DETECTION_DTYPE)
    for i in range(N_DET):
        # inside the zone rows (y 400-1060) so the host mask cascade keeps
        # them: a fair tracker comparison needs survivors on both paths
        y0 = 450.0 + 37 * i + 3 * np.sin(t * 0.3 + i)
        x0 = 150.0 + 290 * i + 4 * np.cos(t * 0.25 + i)
        recs['label'][i] = 1 if i % 2 == 0 else 3     # person / car
        recs['confidence'][i] = 0.55 + 0.05 * i
        recs['bbox'][i] = (y0, x0, y0 + 260, x0 + 130)
    return recs


# copied from scripts/host_budget.py:69-76
def _timeit(fn, reps, per=1):
    for _ in range(min(5, reps)):     # warm
        fn(0)
    t0 = time.perf_counter()
    for t in range(reps):
        fn(t)
    return (time.perf_counter() - t0) / reps / per * 1000.0


def _mask_alpha():
    alpha = np.zeros((H, W), np.uint8)
    alpha[400:1060, 100:1100] = 255
    alpha[500:1060, 1300:1860] = 255
    return alpha


def bench_sieve(device_filters):
    from watsor_tpu_torch.filters import (AreaFilter, ConfidenceFilter,
                                          MaskFilter, TrackFilter, ZoneMask)
    from watsor_tpu_torch.filters.sieve import DetectionSieve

    # area 1%: a 260x130 px box is ~1.6% of 1080p; the default 10% would
    # drop every detection and measure an idle tracker
    detect = [{'person': {'confidence': 50, 'area': 1}},
              {'car': {'confidence': 50, 'area': 1, 'zones': [1, 2]}}]
    if device_filters:
        chain = []
    else:
        zone_mask = ZoneMask(_mask_alpha(), (H, W))
        chain = [ConfidenceFilter(detect), AreaFilter(detect),
                 MaskFilter(detect, zone_mask)]
    track = TrackFilter(chain)
    buf = FrameBuffer(2, W, H)
    frame = buf.frames[0]
    frame.latch = _NoopLatch()
    sieve = DetectionSieve('bench-sieve', Queue(), buf, track)
    rng = np.random.RandomState(0)

    def step(t):
        frame.stamp()
        frame.set_detections(_detections(rng, t))
        sieve._incoming_frame(frame)

    return _timeit(step, REPS['sieve'])


def bench_detector_stage():
    buf = FrameBuffer(2, W, H, detect_hw=(300, 300))
    frame = buf.frames[0]
    staging = np.zeros((16, 300, 300, 3), np.uint8)

    def step(t):
        staging[t % 16] = frame.detect_plane

    return _timeit(step, REPS['detector_stage'])


def scatter_result(batch, rng):
    """The packed step's result tuple (boxes, scores, classes, valid,
    device ms, zones_hit) for ``batch`` frames of N_DET detections each in
    zone 1 (scripts/host_budget.py:144-154)."""
    boxes = rng.rand(batch, 100, 4).astype(np.float32)
    boxes[..., 2:] = np.minimum(boxes[..., :2] + 0.2, 1.0)
    scores = np.zeros((batch, 100), np.float32)
    classes = np.zeros((batch, 100), np.int32)
    scores[:, :N_DET] = 0.6
    classes[:, :N_DET] = 1
    valid = np.full(batch, N_DET, np.int32)
    zones_hit = np.zeros((batch, 100, 10), bool)
    zones_hit[:, :N_DET, 0] = True
    return (boxes, scores, classes, valid, 8.0, zones_hit)


def bench_detector_scatter():
    from watsor_tpu_torch.detection.detector import ObjectDetector

    class _Backend:
        device_name = 'BENCH'
        input_hw = (300, 300)

        def warmup(self, hw=None, batch=1):
            pass

    batch = 16
    buf = FrameBuffer(batch + 1, W, H, detect_hw=(300, 300))
    frames = buf.frames[:batch]
    for f in frames:
        f.latch = _NoopLatch()
    det = ObjectDetector('bench-det', Queue(), {'cam': buf}, _Backend(),
                         max_batch=batch)
    result = scatter_result(batch, np.random.RandomState(0))

    def step(t):
        for f in frames:
            f.stamp()
        det._scatter(result, frames)

    return _timeit(step, REPS['detector_scatter'], per=batch)


def bench_snapshot(worst_case):
    from watsor_tpu_torch.output.snapshot import Snapshot

    buf = FrameBuffer(2, W, H)
    frame = buf.frames[0]
    frame.latch = _NoopLatch()
    snap = Snapshot('bench-snap', Queue(), buf, ['person', 'car'], [])
    rng = np.random.RandomState(0)

    def step(t):
        recs = _detections(rng, t)
        if worst_case:
            # strictly rising sub-epsilon confidence: the snapshot's
            # SNAPSHOT_EPSILON guard keeps this near the steady state
            recs['confidence'] += (t % 1000) * 1e-4
        else:
            recs['confidence'] = 0.3   # never beats the stored best
        frame.stamp()
        frame.set_detections(recs)
        snap._new_frame(frame, None)

    step(0)      # seed the store so the steady state starts stored
    return _timeit(step, REPS['snapshot_copy' if worst_case
                              else 'snapshot_steady'])


def bench_mqtt(details):
    from watsor_tpu_torch.output.mqtt import MQTT
    from watsor_tpu_torch.runtime.meters import FramesPerSecond, RateLimiter
    from watsor_tpu_torch.testing.broker import MiniBroker

    class _FakeDecoder:
        rate_limiter = RateLimiter()
        fps = FramesPerSecond()

        class stop_event:
            @staticmethod
            def is_set():
                return False

        @staticmethod
        def is_shutdown():
            return False

    broker = MiniBroker()
    try:
        buf = FrameBuffer(2, W, H)
        frame = buf.frames[0]
        frame.latch = _NoopLatch()
        stage = MQTT('bench-mqtt', 'bench', Queue(), buf,
                     {'host': '127.0.0.1', 'port': broker.port},
                     ['person', 'car'], _FakeDecoder())
        stage._on_start()
        if not stage._client.connected:
            raise RuntimeError('the MQTT stage did not connect to the broker')
        stage._details_enabled = details
        rng = np.random.RandomState(0)

        def step(t):
            frame.stamp()
            frame.set_detections(_detections(rng, t))
            stage._new_frame(frame, None)

        ms = _timeit(step, REPS['mqtt'])
        stage._client.disconnect()
    finally:
        broker.close()
    return ms


def bench_jpeg():
    from watsor_tpu_torch.output.http_stream import default_jpeg_encode

    image = np.random.RandomState(0).randint(0, 255, (H, W, 3), np.uint8)
    return _timeit(lambda t: default_jpeg_encode(image), REPS['jpeg_1080p'])


# copied from scripts/host_budget.py:247-260
def _viewer_image():
    """A camera-like 1080p scene (gradient and blocks), not white noise,
    which has no spatial redundancy and costs a JPEG encoder more than any
    camera does."""
    rng = np.random.RandomState(0)
    y = np.linspace(0, 255, H, dtype=np.float32)[:, None]
    x = np.linspace(0, 255, W, dtype=np.float32)[None, :]
    img = np.stack([y + 0 * x, 0 * y + x, (y + x) / 2], axis=-1)
    for _ in range(12):                      # objects
        cy, cx = rng.randint(0, H - 160), rng.randint(0, W - 240)
        img[cy:cy + 160, cx:cx + 240] = rng.randint(0, 255, 3)
    img += rng.normal(0, 4, img.shape)       # sensor noise
    return np.clip(img, 0, 255).astype(np.uint8)


def bench_jpeg_scene_legacy():
    """The per-frame encoder (a fresh context a frame, the source
    resolution) on the camera-like scene."""
    from watsor_tpu_torch.output.http_stream import default_jpeg_encode

    image = _viewer_image()
    default_jpeg_encode(image)
    return _timeit(lambda t: default_jpeg_encode(image), REPS['jpeg_viewer'])


def bench_jpeg_viewer(out_hw=None):
    """One MJPEG viewer variant a frame on the persistent encoder (the
    native one where libav loads, else cv2)."""
    from watsor_tpu_torch.output.http_stream import _scaled_encode

    image = _viewer_image()
    encode = _scaled_encode(out_hw, 80)
    encode(image)                             # open the context
    try:
        return _timeit(lambda t: encode(image), REPS['jpeg_viewer'])
    finally:
        encode.close()


# every row of the record, in the script's order
STAGES = {
    'sieve_tracker': lambda: bench_sieve(device_filters=True),
    'sieve_host_cascade': lambda: bench_sieve(device_filters=False),
    'detector_stage': bench_detector_stage,
    'detector_scatter': bench_detector_scatter,
    'snapshot_steady': lambda: bench_snapshot(worst_case=False),
    'snapshot_copy': lambda: bench_snapshot(worst_case=True),
    'mqtt_states': lambda: bench_mqtt(details=False),
    'mqtt_details': lambda: bench_mqtt(details=True),
    'jpeg_1080p': bench_jpeg,
    'jpeg_1080p_scene_legacy': bench_jpeg_scene_legacy,
    'jpeg_1080p_persistent': lambda: bench_jpeg_viewer(None),
    'jpeg_scale2_960x540': lambda: bench_jpeg_viewer((540, 960)),
    'jpeg_scale4_480x270': lambda: bench_jpeg_viewer((270, 480)),
    'jpeg_detect_300x300': lambda: bench_jpeg_viewer((300, 300))}


def cameras_per_core(per_frame_ms, fps=FPS):
    """Cameras one core keeps at ``fps`` frames/s a camera when a frame
    costs ``per_frame_ms`` of host time (scripts/host_budget.py:319)."""
    return 1000.0 / (per_frame_ms * fps)


def cpu_model():
    """The host CPU's model name, or None where it cannot be read."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return None


def measure(device, log=None):
    """scripts/host_budget.py's record, measured in this thread."""
    from watsor_tpu_torch.workload import card_label

    rows = {}
    for name, run in STAGES.items():
        rows[name] = run()
        if log:
            log('{:24s} {:8.4f} ms/frame'.format(name, rows[name]))

    # the steady per-camera per-frame host cost of the serving path
    # (device filters on, MQTT states, snapshot without a copy; JPEG only
    # for viewed cameras, the host cascade only with
    # WATSOR_DEVICE_FILTERS=0)
    per_frame = (rows['sieve_tracker'] + rows['detector_stage'] +
                 rows['detector_scatter'] + rows['snapshot_steady'] +
                 rows['mqtt_states'])
    record = {
        'per_stage_ms_per_frame': {k: round(v, 4) for k, v in rows.items()},
        'steady_path_ms_per_frame': round(per_frame, 4),
        'cameras_per_core_at_30fps': round(cameras_per_core(per_frame), 1),
        'host': {'cores': os.cpu_count(), 'cpu_model': cpu_model(),
                 'note': 'each stage alone in one thread, nothing else '
                         'running; cameras per core assume the stages '
                         'scale linearly over cores'},
        'device': card_label(device),
        'ts': time.strftime('%Y-%m-%dT%H:%M:%S'),
    }
    write_out('HOST_BUDGET_OUT', record, 'w')
    return record
