#!/usr/bin/env python3
"""Drive the PyTorch port of watsor-tpu once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It builds the port's four CUDA kernels from
``watsor_tpu_torch/csrc/`` (one nvcc each, all at once), then:

1. holds each kernel against its plain PyTorch version at its path's
   shapes (fixed_point_suppress, pallas_suppress and int8_matmul_requant
   bit for bit; fused_inverted_residual within a stated tolerance) and
   times both with CUDA events;
2. drives the detection main path (ssd_mobilenet_v2 at 300x300, bf16,
   nms fused_exact, fused blocks, device filters) through
   TorchDetectorBackend inside an ObjectDetector fed from FrameBuffers of
   1920x1080 frames, checks what it wrote and that both of its kernels
   ran, and holds the step's raw outputs against the f32 plain model;
   then the int8 path the same way (WATSOR_QUANTIZE=int8_full,
   WATSOR_INT8_POINTWISE=pallas, calibrated on seeded frames, nms exact),
   with 38 int8_matmul_requant launches a forward and the raw outputs'
   cosine against the f32 plain model;
3. boots TorchApplication on config/config.yaml and waits for detections
   to flow through /metrics, once on the main path and once on the int8
   path with ``nms: exact``;

and last checks that nothing of JAX was imported on the way. It uses one
card, the first visible one. Any failed phase makes the script exit
non-zero without the final line. Weights are random, from a fixed seed.
Output: versions, the card, build time, per-phase lines, a JSON line of
kernel results, and as the last line ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8                    # the main path's batch: 8 cameras

# fused block kernel vs plain, both bf16 with f32 sums rounded at the same
# points: they differ only in f32 summation order, which can flip the
# last bit of a bf16 intermediate or of the bf16 output. 2^-6 relative is
# two bf16 ulps; the mean bound catches a systematic error
FUSED_RTOL, FUSED_ATOL, FUSED_MEAN_ATOL = 2.0 ** -6, 1e-2, 1e-3
# the fused bf16 detector against the f32 plain model: bf16 rounds every
# activation of ~70 layers (2^-9 relative each)
MODEL_REL_TOL = 5e-2
# the int8 walk against the f32 plain model: the bar of
# tests/test_ssd_int8.py (cosine of the raw outputs)
INT8_MIN_COSINE = 0.95
# kernel-4 launches in one int8 forward: its 38 pointwise units
INT8_CALLS = 38


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=7, inner=10):
    """Median per-call device time over ``reps`` runs of ``inner`` calls."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_kernels(device, results):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from watsor_tpu_torch.ops import fused_block, nms_fixed_point
    from watsor_tpu_torch.ops.boxes import iou_matrix
    from watsor_tpu_torch.workload import FUSED_SHAPES, WATCHED

    rng = np.random.default_rng(0)
    M = 128
    entry = {'name': 'fixed_point_suppress', 'route': 'cuda',
             'source': 'watsor_tpu_torch/csrc/nms_fixed_point.cu',
             'replaces': 'watsor_tpu/ops/nms_pallas.py:158',
             'max_abs_err': 0.0}
    for C in (2, 90):
        # scores on a 1/64 grid: many exact ties across candidates
        s = np.floor(rng.uniform(0, 1, (BATCH, C, M)) * 64) / 64
        yx = rng.uniform(0, 1, (BATCH, M, 2))
        hw = rng.uniform(0.02, 0.4, (BATCH, M, 2))
        boxes = torch.tensor(np.concatenate([yx, yx + hw], -1),
                             dtype=torch.float32, device=device)
        scores = torch.tensor(s, dtype=torch.float32, device=device)
        iou = iou_matrix(boxes, boxes).contiguous()
        got = nms_fixed_point.fixed_point_suppress(scores, iou, 0.6)
        want = nms_fixed_point.fixed_point_suppress_plain(scores, iou, 0.6)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                'fixed_point_suppress C={}: {} of {} keep bits differ'.format(
                    C, int((got != want).sum()), got.numel()))
        ms = time_ms(lambda: nms_fixed_point.fixed_point_suppress(
            scores, iou, 0.6))
        plain_ms = time_ms(lambda: nms_fixed_point.fixed_point_suppress_plain(
            scores, iou, 0.6), reps=5, inner=2)
        log('phase1 fixed_point_suppress B={} C={} M={}: bit-identical, '
            'kept {}, kernel {:.4f} ms, plain {:.4f} ms'.format(
                BATCH, C, M, int(got.sum()), ms, plain_ms))
        if C == len(WATCHED):            # the main path's shape
            entry.update(ms=ms, plain_ms=plain_ms)
    results.append(entry)

    entry = {'name': 'fused_inverted_residual', 'route': 'cuda',
             'source': 'watsor_tpu_torch/csrc/fused_block.cu',
             'replaces': 'watsor_tpu/ops/fused_block.py:32',
             'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
    for H, C_in, E, C_out in FUSED_SHAPES:
        def rand(shape, scale, dtype):
            return torch.tensor(rng.normal(0, scale, shape), dtype=dtype,
                                device=device)
        x = rand((BATCH, H, H, C_in), 1.0, torch.bfloat16)
        args = (rand((C_in, E), C_in ** -0.5, torch.bfloat16),
                rand((E,), 0.1, torch.float32),
                rand((3, 3, E), 1 / 3, torch.bfloat16),
                rand((E,), 0.1, torch.float32),
                rand((E, C_out), E ** -0.5, torch.bfloat16),
                rand((C_out,), 0.1, torch.float32))
        residual = C_in == C_out
        got = fused_block.fused_inverted_residual(x, *args,
                                                  residual=residual)
        want = fused_block.fused_inverted_residual_plain(x, *args,
                                                         residual=residual)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        bound = FUSED_ATOL + FUSED_RTOL * want.float().abs()
        err = float(diff.max())
        if bool((diff > bound).any()) or float(diff.mean()) > FUSED_MEAN_ATOL:
            raise AssertionError(
                'fused_inverted_residual {}: max err {} mean {}'.format(
                    (H, C_in, E, C_out), err, float(diff.mean())))
        ms = time_ms(lambda: fused_block.fused_inverted_residual(
            x, *args, residual=residual))
        plain_ms = time_ms(lambda: fused_block.fused_inverted_residual_plain(
            x, *args, residual=residual))
        log('phase1 fused_inverted_residual B={} {}x{} {}->{}->{}{}: '
            'max err {:.3g}, kernel {:.4f} ms, plain {:.4f} ms'.format(
                BATCH, H, H, C_in, E, C_out, ' +res' if residual else '',
                err, ms, plain_ms))
        entry['max_abs_err'] = max(entry['max_abs_err'], err)
        entry['ms'] += ms                # one forward's 12 blocks
        entry['plain_ms'] += plain_ms
    results.append(entry)
    phase_kernels_int8_path(device, results, rng)


def phase_kernels_int8_path(device, results, rng):
    """The int8 path's two kernels against their plain versions."""
    import collections
    import torch
    from watsor_tpu_torch.ops import int8_matmul, nms_suppress
    from watsor_tpu_torch.workload import WATCHED, int8_pointwise_calls

    K = 100                              # per_class_k
    entry = {'name': 'pallas_suppress', 'route': 'cuda',
             'source': 'watsor_tpu_torch/csrc/nms_suppress.cu',
             'replaces': 'watsor_tpu/ops/nms_pallas.py:98',
             'max_abs_err': 0.0}
    for C in (2, 90):
        # score-sorted candidates on a 1/64 grid: many exact ties
        s = -np.sort(-np.floor(rng.uniform(0, 1, (BATCH, C, K)) * 64) / 64,
                     axis=-1)
        yx = rng.uniform(0, 1, (BATCH, C, K, 2))
        hw = rng.uniform(0.02, 0.4, (BATCH, C, K, 2))
        boxes = torch.tensor(np.concatenate([yx, yx + hw], -1),
                             dtype=torch.float32, device=device)
        scores = torch.tensor(s, dtype=torch.float32, device=device)
        got = nms_suppress.pallas_suppress(boxes, scores, 0.6)
        want = nms_suppress.pallas_suppress_plain(boxes, scores, 0.6)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                'pallas_suppress C={}: {} of {} scores differ'.format(
                    C, int((got != want).sum()), got.numel()))
        ms = time_ms(lambda: nms_suppress.pallas_suppress(boxes, scores,
                                                          0.6))
        plain_ms = time_ms(lambda: nms_suppress.pallas_suppress_plain(
            boxes, scores, 0.6), reps=5, inner=2)
        log('phase1 pallas_suppress B={} C={} K={}: bit-identical, kept {}, '
            'kernel {:.4f} ms, plain {:.4f} ms'.format(
                BATCH, C, K, int((got > 0).sum()), ms, plain_ms))
        if C == len(WATCHED):            # the int8 path's shape
            entry.update(ms=ms, plain_ms=plain_ms)
    results.append(entry)

    entry = {'name': 'int8_matmul_requant', 'route': 'cuda',
             'source': 'watsor_tpu_torch/csrc/int8_matmul.cu',
             'replaces': 'watsor_tpu/ops/int8_matmul.py:111',
             'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
    calls = collections.Counter(int8_pointwise_calls(BATCH))
    for (M, K, N, quantize, relu6), n in calls.items():
        x = torch.tensor(rng.integers(-127, 128, (M, K)), dtype=torch.int8,
                         device=device)
        w = torch.tensor(rng.integers(-127, 128, (K, N)), dtype=torch.int8,
                         device=device)
        # outputs spread over about +-60 quanta of 0.047
        scale = torch.tensor(rng.uniform(1.5e-4, 4.5e-4, N) / K ** 0.5,
                             dtype=torch.float32, device=device)
        bias = torch.tensor(rng.normal(0, 0.5, N), dtype=torch.float32,
                            device=device)
        out_scale = 0.047 if quantize else None
        args = (x, w, scale, bias, out_scale, relu6)
        got = int8_matmul.int8_matmul_requant(*args)
        want = int8_matmul.int8_matmul_requant_plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(
                'int8_matmul_requant {}: {} of {} outputs differ, max {}'
                .format((M, K, N, quantize, relu6),
                        int((got != want).sum()), got.numel(), err))
        if quantize and int(got.unique().numel()) < 20:
            raise AssertionError('int8_matmul_requant {}: outputs clipped'
                                 .format((M, K, N)))
        ms = time_ms(lambda: int8_matmul.int8_matmul_requant(*args))
        plain_ms = time_ms(lambda: int8_matmul.int8_matmul_requant_plain(
            *args), reps=5, inner=3)
        log('phase1 int8_matmul_requant M={} K={} N={} {}{} x{}: '
            'bit-identical, kernel {:.4f} ms, plain {:.4f} ms'.format(
                M, K, N, 'int8' if quantize else 'f32',
                ' relu6' if relu6 else '', n, ms, plain_ms))
        entry['max_abs_err'] = max(entry['max_abs_err'], err)
        entry['ms'] += n * ms            # one forward's 38 calls
        entry['plain_ms'] += n * plain_ms
    if sum(calls.values()) != INT8_CALLS:
        raise AssertionError('{} pointwise calls a forward'.format(
            sum(calls.values())))
    results.append(entry)


def phase_pipeline(counters, build, label, n_rounds=24):
    """A detection path: the port's detector task (an ObjectDetector over
    TorchDetectorBackend on the one card, with ``build(device)`` as its
    detector) draining FrameBuffers of BATCH cameras, so every step runs at
    batch BATCH. Returns (detector, launches, batches)."""
    import cv2
    import torch
    from watsor_tpu_torch.detection import (TorchDetectorBackend,
                                            create_object_detectors)
    from watsor_tpu_torch.host import (FrameBuffer, Payload, State,
                                       balanced_queue_group)
    from watsor_tpu_torch.models.zoo import MODEL_REGISTRY
    from watsor_tpu_torch.workload import (FRAME_HW, MODEL, camera_filters,
                                           watched_labels)

    frame_hw = FRAME_HW
    watched = watched_labels()
    cams = ['cam{}'.format(i) for i in range(BATCH)]
    # camera 0 carries the demo zone mask, the others none
    tables, refiners = camera_filters(cams, frame_hw)
    size = MODEL_REGISTRY[MODEL].input_size

    rng = np.random.default_rng(1)
    slots = 3
    buffers = {}
    for cam in cams:
        buf = FrameBuffer(slots, frame_hw[1], frame_hw[0],
                          detect_hw=(size, size))
        for frame in buf.frames:
            frame.image[:] = rng.integers(0, 256, frame.image.shape,
                                          np.uint8)
            cv2.resize(frame.image, (size, size), dst=frame.detect_plane,
                       interpolation=cv2.INTER_LINEAR)
        buffers[cam] = buf
    queues = balanced_queue_group(cams, maxsize=len(cams))

    latencies = []
    built = {}

    class TimedBackend(TorchDetectorBackend):
        def resolve(self, handle):
            result = super().resolve(handle)
            latencies.append(result[4])
            return result

    def backend_factory(device):
        built['detector'] = detector = build(device)
        return TimedBackend(detector, device, camera_tables=tables,
                            zone_refiners=refiners, min_batch=BATCH)

    detectors = create_object_detectors(queues, buffers, backend_factory,
                                         max_batch=BATCH, pool_spec='cuda:1')
    if len(detectors) != 1:
        raise AssertionError('{} detector tasks for one card'.format(
            len(detectors)))
    obj = detectors[0]
    for counter in counters:
        counter.launches = 0
    obj.start()
    try:
        if not obj.ready.wait(600):
            raise AssertionError('detector warmup did not finish')
        warm = len(latencies)
        pushed, checked = [], []
        start = time.perf_counter()
        for r in range(n_rounds):
            for cam in cams:
                frame = buffers[cam].frames[r % slots]
                if r >= slots:                     # the slot's last push
                    if not frame.latch.wait(State.PUBLISH, 60):
                        raise AssertionError('{} frame stuck in {}'.format(
                            cam, frame.latch.state.name))
                    checked.append((cam, frame.detections_view().copy()))
                    frame.latch.next()             # PUBLISH -> READY
                frame.clear()
                frame.stamp()
                frame.latch.next()                 # READY -> DETECT
                queues[cam].put(Payload(cam, r % slots))
                pushed.append(frame)
        for frame in pushed[-len(cams) * slots:]:
            if not frame.latch.wait(State.PUBLISH, 60):
                raise AssertionError('frame stuck in DETECT')
        seconds = time.perf_counter() - start
    finally:
        obj.terminate()
        obj.join(30)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}

    steps = latencies[warm:]
    frames = n_rounds * len(cams)
    if len(steps) < 20:
        raise AssertionError('only {} batches ran'.format(len(steps)))
    fh, fw = frame_hw
    n_det = 0
    for cam, records in checked:
        if not 0 <= len(records) <= 100:
            raise AssertionError('{} detections'.format(len(records)))
        n_det += len(records)
        bbox = records['bbox'] / np.array([fh, fw, fh, fw], np.float32)
        if len(records) and not (np.isfinite(bbox).all() and
                                 bbox.min() >= 0 and bbox.max() <= 1 and
                                 (records['confidence'] > 0).all() and
                                 (records['confidence'] <= 1).all()):
            raise AssertionError('{} wrote malformed detections'.format(cam))
        labels = set(records['label'].tolist())
        if not labels <= set(watched):
            raise AssertionError('unwatched labels {}'.format(labels))
    if n_det == 0:
        raise AssertionError('no detections were written')
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError('{} never launched on the {}'
                                 .format(name, label))
    log('{}: {} frames of {}x{} from {} cameras in {} batches, '
        '{:.1f} frames/s, median batch latency {:.3f} ms, {} detections '
        'written, launches {}'.format(
            label, frames, fw, fh, len(cams), len(steps), frames / seconds,
            statistics.median(steps), n_det, launches))
    return built['detector'], launches, len(latencies)


def phase_reference(device, detector):
    """The fused bf16 step against the f32 plain model on a small input."""
    import torch
    from watsor_tpu_torch.models.ssd import build_detector

    reference = build_detector(
        detector.config._replace(dtype=torch.float32),
        variables=detector.variables, anchors=detector.anchors,
        device=device)
    rng = np.random.default_rng(2)
    images = torch.tensor(rng.integers(0, 256, (2, 300, 300, 3), np.uint8),
                          device=device)
    x = images.float() * (2.0 / 255.0) - 1.0
    with torch.inference_mode():
        gb, gl = detector.raw_apply(x)
        wb, wl = reference.raw_apply(x)
        out = detector.detect_batch(images)
    torch.cuda.synchronize()
    errs = []
    for got, want in ((gb, wb), (gl, wl)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError('non-finite raw outputs')
        errs.append(float((got - want).abs().max() / want.abs().max()))
    if max(errs) > MODEL_REL_TOL:
        raise AssertionError('fused bf16 vs f32 plain: relative errors {}'
                             .format(errs))
    n = detector.config.max_detections
    if tuple(out.boxes.shape) != (2, n, 4) or \
            not bool(torch.isfinite(out.boxes).all()) or \
            not bool(((out.valid >= 0) & (out.valid <= n)).all()):
        raise AssertionError('malformed detect_batch output')
    log('phase2 reference: fused bf16 vs plain f32 raw outputs, relative '
        'max error boxes {:.3g} logits {:.3g} (bound {})'.format(
            errs[0], errs[1], MODEL_REL_TOL))


def phase_int8_reference(device, detector):
    """The int8 walk's raw outputs against the f32 plain model on a small
    input: cosine above INT8_MIN_COSINE for boxes and for logits."""
    import torch
    from watsor_tpu_torch.models.ssd import build_detector

    reference = build_detector(
        detector.config._replace(dtype=torch.float32),
        variables=detector.variables, anchors=detector.anchors,
        device=device)
    rng = np.random.default_rng(3)
    images = torch.tensor(rng.integers(0, 256, (2, 300, 300, 3), np.uint8),
                          device=device)
    x = images.float() * (2.0 / 255.0) - 1.0
    with torch.inference_mode():
        got = detector.raw_apply(x)
        want = reference.raw_apply(x)
        out = detector.detect_batch(images)
    torch.cuda.synchronize()
    cosines = []
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError('non-finite int8 raw outputs')
        g, w = g.double().flatten(), w.double().flatten()
        cosines.append(float(g @ w / (g.norm() * w.norm() + 1e-9)))
    if min(cosines) <= INT8_MIN_COSINE:
        raise AssertionError('int8 vs f32 plain: cosines {}'.format(cosines))
    n = detector.config.max_detections
    if tuple(out.boxes.shape) != (2, n, 4) or \
            not bool(torch.isfinite(out.boxes).all()) or \
            not bool(((out.valid >= 0) & (out.valid <= n)).all()):
        raise AssertionError('malformed int8 detect_batch output')
    log('int8 reference: int8 walk vs plain f32 raw outputs, cosine boxes '
        '{:.5f} logits {:.5f} (bound {})'.format(cosines[0], cosines[1],
                                                 INT8_MIN_COSINE))


def _free_port():
    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def phase_app(label, env, nms=None, deadline_s=600):
    """TorchApplication on config/config.yaml, with the environment knobs
    ``env`` (None removes one) and ``nms`` set in the copied config, until
    detections flow."""
    from watsor_tpu_torch.main import (TorchApplication,
                                       _parse_commandline_arguments)

    workdir = tempfile.mkdtemp(prefix='watsor-smoke-')
    port = _free_port()
    try:
        for name in ('config.yaml', 'porch_mask.png', 'secrets.yaml'):
            shutil.copy(os.path.join(ROOT, 'config', name), workdir)
        path = os.path.join(workdir, 'config.yaml')
        with open(path) as f:
            text = f.read().replace('port: 8080', 'port: {}'.format(port))
        if nms:
            text = text.replace('# nms: fused_exact', 'nms: ' + nms)
            if 'nms: ' + nms not in text:
                raise AssertionError('config/config.yaml has no nms line')
        with open(path, 'w') as f:
            f.write(text)
        args = _parse_commandline_arguments(
            ['-c', path, '-m', os.path.join(workdir, 'no_weights')])
        for knob, value in env.items():
            if value is None:
                os.environ.pop(knob, None)
            else:
                os.environ[knob] = value
        app = TorchApplication(args)
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        url = 'http://127.0.0.1:{}'.format(port)
        metrics, health = None, None
        try:
            deadline = time.time() + deadline_s
            while time.time() < deadline:
                time.sleep(1.0)
                try:
                    with urllib.request.urlopen(url + '/health',
                                                timeout=2) as r:
                        health = r.read().decode()
                    with urllib.request.urlopen(url + '/metrics',
                                                timeout=2) as r:
                        metrics = json.loads(r.read())
                except OSError:
                    continue
                detectors = metrics.get('detectors') or []
                if detectors and detectors[0]['fps'] > 0:
                    break
            else:
                raise AssertionError('no detections flowed within {} s: {}'
                                     .format(deadline_s, metrics))
        finally:
            app._stop_main.set()
            thread.join(60)
        if health != 'UP':
            raise AssertionError('/health answered {!r}'.format(health))
        log('{}: /health {}, detectors {}'.format(
            label, health, json.dumps(metrics['detectors'])))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _jax_modules():
    return sorted(name for name in sys.modules
                  if name.split('.')[0] in ('jax', 'jaxlib', 'flax'))


def main():
    # one card, the first visible one, so that device_count() below is the
    # number of cards the run used
    visible = os.environ.get('CUDA_VISIBLE_DEVICES')
    os.environ['CUDA_VISIBLE_DEVICES'] = '0' if visible is None \
        else visible.split(',')[0]
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from watsor_tpu_torch import _build
        from watsor_tpu_torch.ops import (fused_block, int8_matmul,
                                          nms_fixed_point, nms_suppress)
    except ImportError as exc:
        print('chip_smoke: the watsor_tpu_torch package is missing: {}'
              .format(exc), file=sys.stderr)
        return 1

    # f32 comparisons on the card need full f32 (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    log('python {}, torch {}, CUDA {}'.format(
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else 'nvidia-smi: {}'.format(smi.stderr.strip())
    log(card)

    failures = []
    start = time.perf_counter()
    libraries = {'nms_fixed_point': nms_fixed_point._SIGNATURES,
                 'fused_block': fused_block._SIGNATURES,
                 'nms_suppress': nms_suppress._SIGNATURES,
                 'int8_matmul': int8_matmul._SIGNATURES}
    try:
        # one nvcc for each source, all started together
        with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
            for future in [pool.submit(_build.load, name, signatures)
                           for name, signatures in libraries.items()]:
                future.result()
        log('build: {} kernels in {:.1f} s'.format(
            len(libraries), time.perf_counter() - start))
    except Exception:
        traceback.print_exc()
        log('chip_smoke: kernel build FAILED')
        return 1

    from watsor_tpu_torch.workload import (build_int8_path_detector,
                                           build_main_path_detector,
                                           calibration_frames)
    results = []
    state = {'launches': {}}

    def main_path():
        state['detector'], launches, _ = phase_pipeline(
            (nms_fixed_point.fixed_point_suppress,
             fused_block.fused_inverted_residual),
            build_main_path_detector, 'phase2 pipeline (main path)')
        state['launches'].update(launches)

    def int8_path():
        calib = calibration_frames()
        state['int8'], launches, batches = phase_pipeline(
            (nms_suppress.pallas_suppress, int8_matmul.int8_matmul_requant),
            lambda device: build_int8_path_detector(device, calib),
            'int8 pipeline')
        state['launches'].update(launches)
        n = launches['int8_matmul_requant']
        if n % INT8_CALLS or n < INT8_CALLS * batches:
            raise AssertionError('{} int8_matmul_requant launches for {} '
                                 'batches; {} a forward expected'.format(
                                     n, batches, INT8_CALLS))

    # (name, run, the phase it needs)
    phases = [
        ('phase1 kernels', lambda: phase_kernels(device, results), None),
        ('phase2 pipeline', main_path, None),
        ('phase2 reference',
         lambda: phase_reference(device, state['detector']),
         'phase2 pipeline'),
        ('int8 pipeline', int8_path, None),
        ('int8 reference',
         lambda: phase_int8_reference(device, state['int8']),
         'int8 pipeline'),
        ('phase3 application',
         lambda: phase_app('phase3 application (main path)',
                           {'WATSOR_FUSED_BLOCKS': '1'}), None),
        ('phase3 application int8',
         lambda: phase_app('phase3 application (int8 path, nms exact)',
                           {'WATSOR_FUSED_BLOCKS': None,
                            'WATSOR_QUANTIZE': 'int8_full',
                            'WATSOR_INT8_POINTWISE': 'pallas'},
                           nms='exact'), None)]
    for name, run, needs in phases:
        if needs in failures:
            failures.append(name)
            log('{} SKIPPED: {} failed'.format(name, needs))
            continue
        try:
            run()
        except Exception:
            traceback.print_exc()
            failures.append(name)
            log('{} FAILED'.format(name))
    jax_modules = _jax_modules()
    if jax_modules:
        failures.append('no-jax check')
        log('chip_smoke: the port imported {}'.format(', '.join(jax_modules)))
    if failures:
        log('chip_smoke: failed phases: {}'.format(', '.join(failures)))
        return 1
    for entry in results:
        entry['launches'] = state['launches'][entry['name']]
    log(json.dumps({'kernels': [
        {key: entry[key] for key in ('name', 'route', 'source', 'replaces',
                                     'launches', 'max_abs_err', 'ms',
                                     'plain_ms')} for entry in results]}))
    count = torch.cuda.device_count()
    if count != 1:
        log('chip_smoke: {} cards visible, the run used one'.format(count))
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
