"""Step profile of the port's main path on one CUDA card.

    python -m watsor_tpu_torch.profile_step [--path main|int8|nms|fleet|train|app]
                                            [--mesh DxM]
                                            [--model NAME[,NAME...]]
                                            [--min-blocks 132,264]
                                            [--baseline OTHER_CHECKOUT]
                                            [--int8-plans] [--pool-only]
                                            [--trace step_trace.json]

Drives a workload of chip_smoke.py (``watsor_tpu_torch.workload``) at
batch 8 and prints a line per measurement, then all of them as one JSON
object on the last line. ``--path main`` (the default) profiles the fused
walk with ``nms: fused_exact``; ``--path int8`` the int8 walk
(int8_full, pointwise units through the kernel) with ``nms: exact``;
``--path nms`` only the two suppression kernels; ``--path fleet`` the
fleet and the device overlay on every visible card; ``--path train`` the
full-width train step (``profile_train``), with ``--mesh DxM`` the sharded
step over a data x model mesh of the visible cards
(``profile_sharded_train``); ``--path app`` the application under
``python -m watsor_tpu_torch.bench app`` (``profile_app``: BASELINE5_*
as there, 32 cameras of 1080p by default), with two 5 s windows once it is
warm: the detector's steps (batches served, a step's cycle) and its
task's time by part (staging frames, dispatch, the wait for the device,
the rest of resolve, scattering results, the rest) beside the process's
CPU time, then the card's busy share under torch.profiler:

- the forward of the plain bf16 model (convolutions with BatchNorm) and of
  the path's walk, as device time (CUDA-graph replay, which leaves out the
  host's launches) and as CUDA-event time around eager launches, each
  model twice in the order plain, path, path, plain;
- ``TorchDetectorBackend.detect_batch`` wall time a step (H2D, detect,
  filters, pack, the one D2H) in the same turns (the plain model with
  ``nms: fused_exact``);
- the path's NMS and its whole detect step as device time;
- a torch.profiler window over 10 of the path's backend steps: wall time,
  the device's busy share (the union of its kernel and copy intervals),
  device events a step, and the kernels with the most device time;
- main path: the 12 fused blocks as device time, the kernel with the
  launch plan of each ``--min-blocks`` (and the kernel of the
  ``--baseline`` checkout) against the plain version and cuDNN's
  three-convolution block;
- int8 path: a row for each distinct shape of one forward's 38
  int8_matmul_requant calls (the kernel, the ``--baseline`` checkout's
  kernel, the plain version, ``torch._int_mm`` alone and followed by the
  epilogue as PyTorch ops, the bound, the launch plan) and their totals;
  with ``--int8-plans`` every launch plan of the kernel at each shape; the
  per-class suppression at C = 2 and C = 90, kernel against plain version;
- the host's cost of one launch through each of the path's kernel
  wrappers (checks, output allocation, the ctypes call), at its shapes;
- ``--model`` (instead of a path): each named family of the zoo at full
  width (bf16, ``nms: fused_exact``, all 90 classes, 8 frames of
  1920x1080): its forward, its fused NMS stage and its whole detect step
  (resize included) as device time, kernel 1's launches a step, and a
  torch.profiler window over 10 backend steps fed the frames resized to
  the model's size (the cameras' detect planes);
- nms: each suppression kernel at its path's shape and at C = 90, device
  and CUDA-event time, an empty kernel launched with the same grid (the
  card's floor for a launch), and the per-phase split of a build with
  WT_PHASE_CLOCK (each block's %globaltimer and clock64 at its phase
  boundaries);
- fleet: the main path's detector behind FleetBackend over make_mesh()
  (every visible card) and over two shards of the first card, at 16, 32
  and 64 detect planes of 300x300: each shard's packed output against
  TorchDetectorBackend's on the first card for the shard's frames (bit for
  bit), kernel 1 and 2 launches a step, the step's wall time beside the
  single backend's in turns single, fleet, fleet, single, and a profiler
  window of the fleet's steps (the busy share is the union over every
  card); then render_boxes at 16 frames of 1920x1080 (100 box slots, 30
  valid) as device time with TF32 off and on, and its kernels in a
  profiler window; ``--pool-only`` keeps the mesh over every card alone.

``--baseline`` takes another checkout, unpacked with ``git archive``, and
builds its kernel of the path from its ``csrc/`` beside this one's: on the
main path its fused-block kernel, bound with the C entry of the second
version (a launch plan from ``ops/fused_block.py plan_launch``); on the
int8 path its int8 kernel, bound with the C entry of the first version
(no plan); on the main path also its fixed_point_suppress with the IoU
matrix its first version reads (the NMS stage, the detect step and a
profiler window with it); for nms its two suppression kernels (kernel 1
with the IoU matrix), with their phase split where its sources have
WT_PHASE_CLOCK. Versions take turns A B B A.

Every time is a median. The card's name and power limit head the output;
compare numbers only within one run.
"""

import argparse
import bisect
import ctypes
import json
import os
import statistics
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from watsor_tpu_torch import _build
from watsor_tpu_torch.detection import TorchDetectorBackend
from watsor_tpu_torch.ops import fused_block
from watsor_tpu_torch.ops.boxes import decode_boxes
from watsor_tpu_torch.ops.nms import (FUSED_SUPPRESSION,
                                      batched_class_aware_nms,
                                      batched_class_aware_nms_fused_late)
from watsor_tpu_torch.workload import (BATCH, FRAME_HW, FUSED_SHAPES, Bound,
                                       build_int8_path_detector,
                                       build_main_path_detector,
                                       calibration_frames, camera_filters,
                                       card_label, cudnn_block,
                                       int8_call_work, int_mm_operand)


def wall_ms(fn, n):
    """Median host time of a synchronized call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def events_ms(fn, n=10, reps=5):
    """Median CUDA-event time a call, eager launches included."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def graph_ms(fn, n=10, reps=7):
    """Median device time a call, from replays of a CUDA graph of n calls
    (the host's launches are left out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def host_us(fn, n=200, sync_every=50):
    """Median host time of one call that is not waited for, in us."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e6)
        if i % sync_every == sync_every - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times)


def log(results, key, value, text):
    results[key] = value
    print(text, flush=True)


def profile_models(device, results, steps, path='main',
                   baseline_suppress=None):
    """Plain against the path's walk, NMS and the whole step; returns the
    profiler window of the path's backend steps. ``baseline_suppress``
    (main path): another fixed_point_suppress, whose NMS stage, detect
    step and profiler window are measured beside this tree's."""
    plain = build_main_path_detector(device, fused=False)
    if path == 'main':
        walk, name = build_main_path_detector(device, fused=True), 'fused'
    else:
        walk = build_int8_path_detector(device, calibration_frames())
        name = 'int8'
    cameras = ['cam{}'.format(i) for i in range(BATCH)]
    tables, refiners = camera_filters(cameras, FRAME_HW)
    size = plain.config.input_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (BATCH, size, size, 3), np.uint8)
    x = torch.tensor(images, device=device).float() * (2 / 255) - 1

    def backend(detector):
        return TorchDetectorBackend(detector, device, camera_tables=tables,
                                    zone_refiners=refiners, min_batch=BATCH)

    turns = defaultdict(list)
    with torch.inference_mode():
        for label, det in (('plain', plain), (name, walk), (name, walk),
                           ('plain', plain)):
            be = backend(det)
            step = wall_ms(lambda: be.detect_batch(images, senders=cameras),
                           steps)
            fwd = events_ms(lambda: det.raw_apply(x))
            fwd_dev = graph_ms(lambda: det.raw_apply(x))
            turns[label].append({'step_wall_ms': step,
                                 'forward_events_ms': fwd,
                                 'forward_device_ms': fwd_dev})
            print('{}: detect_batch wall {:.3f} ms, forward {:.3f} ms with '
                  'host launches, {:.3f} ms on the device'.format(
                      label, step, fwd, fwd_dev), flush=True)
        results['turns'] = dict(turns)

        cfg = walk.config
        box_enc, logits = walk.raw_apply(x)
        cls = logits[..., sorted(cfg.active_labels)].contiguous()
        anchors = torch.from_numpy(walk.anchors).to(device)
        if path == 'main':
            def nms():
                return batched_class_aware_nms_fused_late(
                    box_enc, cls, anchors,
                    scales=tuple(cfg.box_coder_scales),
                    iou_threshold=cfg.iou_threshold,
                    score_threshold=cfg.score_threshold,
                    max_detections=cfg.max_detections,
                    suppression=FUSED_SUPPRESSION[cfg.nms_mode])
        else:
            boxes = decode_boxes(box_enc, anchors,
                                 scales=tuple(cfg.box_coder_scales))
            scores = torch.sigmoid(cls)

            def nms():
                return batched_class_aware_nms(
                    boxes, scores, iou_threshold=cfg.iou_threshold,
                    score_threshold=cfg.score_threshold,
                    max_detections=cfg.max_detections, mode=cfg.nms_mode)
        nms_dev = graph_ms(nms)
        log(results, 'nms_device_ms', nms_dev,
            '{} NMS: {:.4f} ms on the device'.format(cfg.nms_mode, nms_dev))
        nms_ev = events_ms(nms)
        log(results, 'nms_events_ms', nms_ev,
            '{} NMS: {:.4f} ms with host launches'.format(cfg.nms_mode,
                                                          nms_ev))
        u8 = torch.tensor(images, device=device)
        step_dev = graph_ms(lambda: walk.detect_batch(u8))
        log(results, 'detect_step_device_ms', step_dev,
            '{} detect step (resize, forward, NMS): {:.3f} ms on the '
            'device'.format(name, step_dev))
        if baseline_suppress is not None:
            with _suppression(baseline_suppress):
                for key, fn in (('nms_device_ms', nms),
                                ('detect_step_device_ms',
                                 lambda: walk.detect_batch(u8))):
                    ms = graph_ms(fn)
                    log(results, 'baseline_' + key, ms,
                        'with the baseline kernel 1: {} {:.4f}'.format(
                            key, ms))
                profile_trace(backend(walk), images, cameras, results,
                              name + ' (baseline kernel 1)',
                              key='profile_baseline')

    return profile_trace(backend(walk), images, cameras, results, name)


def profile_family(device, results, name, steps=10):
    """One family of the zoo on the card: forward, fused NMS and detect
    step as device time, kernel 1's launches a step, a profiler window."""
    from watsor_tpu_torch.models.efficientdet import EfficientDetConfig
    from watsor_tpu_torch.ops import nms_fixed_point
    from watsor_tpu_torch.ops.preprocess import resize_bilinear
    from watsor_tpu_torch.workload import build_family_detector, frames_1080p

    row = {}
    detector = build_family_detector(device, name)
    cfg = detector.config
    frames = frames_1080p(device)
    offset = 0 if isinstance(cfg, EfficientDetConfig) else 1
    with torch.inference_mode():
        x = resize_bilinear(frames, cfg.input_size, cfg.input_size).to(
            cfg.dtype)
        box_enc, logits = detector.model(x)
        anchors = torch.from_numpy(detector.anchors).to(device)
        fp = nms_fixed_point.fixed_point_suppress
        fp.launches = 0
        detector.detect_batch(frames)
        torch.cuda.synchronize()
        row['kernel1_launches_a_step'] = fp.launches
        row['forward_device_ms'] = graph_ms(lambda: detector.model(x))
        row['nms_device_ms'] = graph_ms(
            lambda: batched_class_aware_nms_fused_late(
                box_enc, logits[..., offset:], anchors,
                scales=tuple(cfg.box_coder_scales),
                iou_threshold=cfg.iou_threshold,
                score_threshold=cfg.score_threshold,
                max_detections=cfg.max_detections,
                suppression=FUSED_SUPPRESSION[cfg.nms_mode]))
        row['detect_step_device_ms'] = graph_ms(
            lambda: detector.detect_batch(frames))
    print('{} ({}x{}, {} anchors): forward {:.4f} ms, fused_exact NMS '
          '{:.4f} ms, detect step {:.4f} ms on the device; kernel 1 '
          '{} a step'.format(name, cfg.input_size, cfg.input_size,
                             len(detector.anchors), row['forward_device_ms'],
                             row['nms_device_ms'],
                             row['detect_step_device_ms'],
                             row['kernel1_launches_a_step']), flush=True)
    cameras = ['cam{}'.format(i) for i in range(BATCH)]
    tables, refiners = camera_filters(cameras, FRAME_HW)
    backend = TorchDetectorBackend(detector, device, camera_tables=tables,
                                   zone_refiners=refiners, min_batch=BATCH)
    # the backend takes the cameras' detect planes, at the model's size
    planes = x.float().round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    profile_trace(backend, planes, cameras, row, name, steps=steps, top=6)
    results.setdefault('families', {})[name] = row


class _suppression:
    """ops/nms.py's suppression wrapper ``name`` (the greedy one by
    default) replaced by ``suppress`` for a block; ``saved`` is the
    wrapper it replaced."""

    def __init__(self, suppress, name='fixed_point_suppress'):
        self.suppress = suppress
        self.name = name

    def __enter__(self):
        from watsor_tpu_torch.ops import nms
        self.saved = getattr(nms, self.name)
        setattr(nms, self.name, self.suppress)
        return self

    def __exit__(self, *exc):
        from watsor_tpu_torch.ops import nms
        setattr(nms, self.name, self.saved)


def profile_trace(be, images, cameras, results, label, steps=10, top=12,
                  key='profile'):
    """torch.profiler over ``steps`` backend steps, into results[key];
    returns the profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        be.detect_batch(images, senders=cameras)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            be.detect_batch(images, senders=cameras)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    results[key] = device_summary(prof, steps, wall, label, top)
    return prof


def device_spans(prof):
    """(start us, end us, name) of every kernel and copy of a profile on
    the device; the device-side spans of user annotations (the optimizer's
    ``Optimizer.step#...``) are left out."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type.name == 'CUDA'
                  and not getattr(e, 'is_user_annotation', False))


def busy_us(spans):
    """The union of the spans' intervals, in us."""
    total, cur_start, cur_end = 0.0, None, None
    for s, e, _ in sorted(spans):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def device_summary(prof, steps, wall, label, top=12):
    """A profiler window of ``steps`` steps over ``wall`` ms: the device's
    busy share (the union of its kernel and copy intervals), device events
    a step, the kernels with the most device time; printed and returned."""
    spans = device_spans(prof)
    busy = busy_us(spans)
    per_kernel = defaultdict(lambda: [0, 0.0])
    for s, e, name in spans:
        per_kernel[name][0] += 1
        per_kernel[name][1] += e - s
    total_us = sum(t for _, t in per_kernel.values()) or 1.0
    kernels = [{'name': name[:80], 'calls': n, 'us_per_call': t / n,
                'share': t / total_us}
               for name, (n, t) in sorted(per_kernel.items(),
                                          key=lambda kv: -kv[1][1])[:top]]
    print('torch.profiler, {} {} steps: wall {:.3f} ms, device busy '
          '{:.3f} ms ({:.1%}), {:.0f} device events a step'.format(
              steps, label, wall, busy / 1e3, busy / 1e3 / wall,
              len(spans) / steps), flush=True)
    for k in kernels:
        print('  {:6.1%} {:5d} x {:9.2f} us  {}'.format(
            k['share'], k['calls'], k['us_per_call'], k['name']))
    return {'steps': steps, 'wall_ms': wall, 'device_busy_ms': busy / 1e3,
            'busy_share': busy / 1e3 / wall,
            'device_events_per_step': len(spans) / steps,
            'top_kernels': kernels}


class StepClock:
    """The detector task's time by part while ``on`` is set:
    ``ObjectDetector._stage`` (one frame copied into the staging batch),
    TorchDetectorBackend's ``dispatch`` (the pinned copy, H2D and the
    step's launches), its ``resolve`` as the wait for the step's event and
    the rest (the D2H copy, unpacking, the zone refinement), and
    ``ObjectDetector._scatter`` (a step's results into its frames'
    headers); and a row a step: when it was dispatched, its frames, its
    padded batch."""

    PARTS = ('stage', 'dispatch', 'wait', 'finish', 'scatter')

    def __init__(self):
        self.on = threading.Event()
        self._lock = threading.Lock()
        self._saved = []
        self._steps, self._parts = [], defaultdict(list)

    def window(self, seconds):
        """(steps, {part: [ms a call]}) of the next ``seconds`` s."""
        with self._lock:
            self._steps, self._parts = [], defaultdict(list)
        self.on.set()
        time.sleep(seconds)
        self.on.clear()
        with self._lock:
            return sorted(self._steps), dict(self._parts)

    def _add(self, part, t0, t1):
        if self.on.is_set():
            with self._lock:
                self._parts[part].append((t1 - t0) * 1e3)

    def _patch(self, cls, name, wrap):
        original = getattr(cls, name)
        self._saved.append((cls, name, original))
        setattr(cls, name, wrap(original))

    def __enter__(self):
        from watsor_tpu_torch.detection.detector import ObjectDetector

        def timed(part):
            def wrap(original):
                def run(*args, **kwargs):
                    t0 = time.perf_counter()
                    out = original(*args, **kwargs)
                    self._add(part, t0, time.perf_counter())
                    return out
                return run
            return wrap

        def dispatch(original):
            def run(backend, images_u8, senders=None):
                t0 = time.perf_counter()
                handle = original(backend, images_u8, senders=senders)
                self._add('dispatch', t0, time.perf_counter())
                if self.on.is_set():
                    with self._lock:
                        self._steps.append((t0, images_u8.shape[0],
                                            handle[0].shape[0]))
                return handle
            return run

        def resolve(original):
            def run(backend, handle):
                t0 = time.perf_counter()
                if handle[1] is not None:
                    handle[1].synchronize()
                t1 = time.perf_counter()
                out = original(backend, handle)
                self._add('wait', t0, t1)
                self._add('finish', t1, time.perf_counter())
                return out
            return run

        self._patch(ObjectDetector, '_stage', timed('stage'))
        self._patch(ObjectDetector, '_scatter', timed('scatter'))
        self._patch(TorchDetectorBackend, 'dispatch', dispatch)
        self._patch(TorchDetectorBackend, 'resolve', resolve)
        return self

    def __exit__(self, *exc):
        for cls, name, original in reversed(self._saved):
            setattr(cls, name, original)
        self._saved = []


def step_split(steps, parts, seconds):
    """One StepClock window of ``seconds`` s: the batches served, a step's
    cycle (dispatch to the next dispatch), each part's ms a call (``stage``
    a frame, the others a step; median and p95) and its share of the
    window; ``other`` is the rest of the detector task's time (gathering
    frames from the queue, the loop's own Python)."""
    def q(values, pct):
        return round(float(np.percentile(values, pct)), 3) if values \
            else None

    frames = [n for _, n, _ in steps]
    cycles = [(b[0] - a[0]) * 1e3 for a, b in zip(steps, steps[1:])]
    buckets = defaultdict(int)
    for _, _, bucket in steps:
        buckets[bucket] += 1
    split = {'steps': len(steps),
             'frames_per_s': round(sum(frames) / seconds, 1),
             'batch_mean': round(float(np.mean(frames)), 2)
             if frames else None,
             'batch_min': min(frames, default=None),
             'batch_max': max(frames, default=None),
             'buckets': dict(sorted(buckets.items())),
             'cycle_ms': [q(cycles, 50), q(cycles, 95)]}
    shares = {}
    for part in StepClock.PARTS:
        values = parts.get(part, [])
        split[part + '_ms'] = [q(values, 50), q(values, 95)]
        shares[part] = round(sum(values) / 1e3 / seconds, 4)
    shares['other'] = round(1.0 - sum(shares.values()), 4)
    split['shares'] = shares
    return split


def profile_app(device, results, window_s=5.0, at_sample=2):
    """``bench app`` (its BASELINE5_* settings; the path by the service's
    knobs) with two windows of ``window_s`` s at its ``at_sample``-th
    /metrics sample: the detector task's time by StepClock
    (``step_split``) beside the process's CPU time, then the same under
    torch.profiler on the card (the device's busy share, events a step,
    top kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from watsor_tpu_torch import bench
    clock = StepClock()
    samples = []

    def summarize(metrics):
        samples.append(None)
        if len(samples) == at_sample:
            cpu, t0 = time.process_time(), time.perf_counter()
            split = step_split(*clock.window(window_s), window_s)
            split.update(
                process_cpu_cores=round((time.process_time() - cpu) /
                                        (time.perf_counter() - t0), 3),
                threads=threading.active_count(),
                switch_interval_ms=sys.getswitchinterval() * 1e3)
            results['app_steps'] = split
            print('app, {:.0f} s: {}'.format(window_s, json.dumps(split)),
                  flush=True)
            with profile(activities=[ProfilerActivity.CUDA
                                     if device.type == 'cuda'
                                     else ProfilerActivity.CPU]) as prof:
                t0 = time.perf_counter()
                steps, parts = clock.window(window_s)
                wall = (time.perf_counter() - t0) * 1e3
            results['app_profile'] = device_summary(
                prof, max(len(steps), 1), wall, 'app')
            results['app_profile']['steps_under_profiler'] = step_split(
                steps, parts, window_s)
        return bench.aggregate(metrics)

    with clock:
        record = bench.run_app(device, summarize=summarize)
    if 'app_profile' not in results:
        raise RuntimeError('the app ended before sample {}'.format(at_sample))
    results['app'] = {k: v for k, v in record.items() if k != 'samples'}
    print('app: {}'.format(json.dumps(results['app'])), flush=True)


def profile_fleet(device, results, steps, pool_only=False):
    """The fleet and the device overlay (see the module docstring); with
    ``pool_only`` the mesh over every visible card alone."""
    from torch.profiler import ProfilerActivity, profile
    from watsor_tpu_torch.detection import FleetBackend
    from watsor_tpu_torch.ops import nms_fixed_point
    from watsor_tpu_torch.ops.overlay import (coco_color_table, pixel_index,
                                              render_boxes)
    from watsor_tpu_torch.parallel import FleetDetector, make_mesh
    from watsor_tpu_torch.workload import (detect_planes,
                                           fleet_against_single,
                                           overlay_inputs, overlay_work)

    detector = build_main_path_detector(device)
    counters = (nms_fixed_point.fixed_point_suppress,
                fused_block.fused_inverted_residual)
    batches = (16, 32, 64)
    cameras = ['cam{}'.format(i) for i in range(max(batches))]
    tables, refiners = camera_filters(cameras, FRAME_HW)
    planes = detect_planes(max(batches), seed=4)
    single = TorchDetectorBackend(detector, device, camera_tables=tables,
                                  zone_refiners=refiners)

    rows = []
    meshes = [make_mesh()]
    if not pool_only:
        meshes.append(make_mesh(devices=[device, device]))
    for mesh in meshes:
        start = time.perf_counter()
        fleet = FleetDetector(mesh, detector)
        build_s = time.perf_counter() - start
        backend = FleetBackend(fleet, camera_tables=tables,
                               zone_refiners=refiners)
        for batch in batches:
            row = fleet_against_single(backend, single, planes[:batch],
                                       cameras[:batch], counters, steps)
            row.update(mesh=backend.device_name, batch=batch,
                       devices=[str(d) for d in mesh.devices],
                       replicas_build_s=build_s)
            rows.append(row)
            print('fleet {} batch {} ({} shards of {}): bit-identical to '
                  'TorchDetectorBackend on each shard {}, launches {}; step '
                  'wall {} ms, TorchDetectorBackend {} ms'.format(
                      backend.device_name, batch, row['shards'], row['shard'],
                      row['equal'], row['launches'],
                      ' / '.join('{:.3f}'.format(t)
                                 for t in row['fleet_wall_ms']),
                      ' / '.join('{:.3f}'.format(t)
                                 for t in row['single_wall_ms'])), flush=True)
            if not all(row['equal']):
                raise AssertionError('fleet output differs from the single '
                                     'backend')
        profile_trace(backend, planes[:32], cameras[:32], results,
                      'fleet {} batch 32'.format(backend.device_name),
                      key='profile_{}'.format(backend.device_name))
    results['fleet'] = rows
    if pool_only:
        return

    frames, boxes, classes = overlay_inputs()
    B, H, W, _ = frames.shape
    args = [torch.from_numpy(a).to(device) for a in (frames, boxes, classes)]
    table = coco_color_table(device)
    index = pixel_index(H, W, device)
    nbytes, ops = overlay_work(B, H, W, boxes.shape[1])
    overlay = {'bound_bytes_ms': Bound().add(nbytes).ms}
    with torch.inference_mode():
        for mode in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = mode
            key = 'tf32' if mode else 'f32'
            overlay[key + '_device_ms'] = graph_ms(
                lambda: render_boxes(*args, table, index=index), n=3, reps=5)
            overlay[key + '_events_ms'] = events_ms(
                lambda: render_boxes(*args, table, index=index), n=3)
            overlay[key + '_bound_ops_ms'] = Bound().add(0, **{key: ops}).ms
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    render_boxes(*args, table, index=index)
                torch.cuda.synchronize()
            per_kernel = defaultdict(float)
            for e in prof.events():
                if e.device_type.name == 'CUDA':
                    per_kernel[e.name[:70]] += (e.time_range.end -
                                                e.time_range.start) / 3e3
            overlay[key + '_kernels_ms'] = dict(sorted(
                per_kernel.items(), key=lambda kv: -kv[1])[:8])
            print('render_boxes [{}, {}, {}, 3] TF32 {}: {:.4f} ms on the '
                  'device, {:.4f} ms with host launches; bound {:.4f} ms '
                  '(bytes), {:.4f} ms (operations)'.format(
                      B, H, W, 'on' if mode else 'off',
                      overlay[key + '_device_ms'],
                      overlay[key + '_events_ms'], overlay['bound_bytes_ms'],
                      overlay[key + '_bound_ops_ms']), flush=True)
            for name, ms in overlay[key + '_kernels_ms'].items():
                print('  {:8.4f} ms  {}'.format(ms, name), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    results['overlay'] = overlay


def profile_train(device, results, steps, trace=None):
    """--path train: the full-width train step (ssd_mobilenet_v2 at
    300x300, bf16 activations, f32 parameters, AdamW, TRAIN_BATCH painted
    images already on the card): its wall time a step (host clock to a
    synchronize) and CUDA-event time, images/s, peak device memory, the
    FLOPs that FlopCounterMode counts in one step and their share of the
    card's bf16 dense peak; a profiler window of 10 steps (busy share,
    device events a step, top kernels); and the device time of the forward
    with its loss, the backward and the optimizer, from a window of steps
    synchronized between the phases, each kernel counted in the phase
    during whose host span it ran."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils.flop_counter import FlopCounterMode
    from watsor_tpu_torch.workload import (PEAK_OPS_S, TRAIN_BATCH,
                                           build_train_state,
                                           timed_train_steps, train_batch)
    config, state, step = build_train_state(device)
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in train_batch(config.input_size).items()}
    timed_train_steps(state, step, batch, 5)
    torch.cuda.reset_peak_memory_stats(device)
    rows = timed_train_steps(state, step, batch, steps)
    peak = torch.cuda.max_memory_allocated(device)
    wall = statistics.median(r['wall_ms'] for r in rows)
    event = statistics.median(r['event_ms'] for r in rows)
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    flops = counter.get_total_flops()

    window = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(window):
            step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    if trace:
        prof.export_chrome_trace(trace)
    summary = device_summary(prof, window, window_ms,
                             'train ({})'.format(config.dtype))

    # the phases: each ends in a synchronize inside its profiler range, so
    # that its kernels start inside the range
    phases = ('forward', 'backward', 'optimizer')
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            with record_function('train_forward'):
                loss, _ = step.loss_fn(state.model, batch)
                torch.cuda.synchronize()
            with record_function('train_backward'):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                torch.cuda.synchronize()
            with record_function('train_optimizer'):
                state.optimizer.step()
                torch.cuda.synchronize()
    ranges = defaultdict(list)
    for e in prof.events():
        if e.device_type.name == 'CPU' and e.name.startswith('train_'):
            ranges[e.name[len('train_'):]].append(
                (e.time_range.start, e.time_range.end))
    kernels = device_spans(prof)
    phase_us = {phase: busy_us([e for e in kernels if any(
        a <= e[0] < b for a, b in ranges[phase])]) / window
        for phase in phases}
    peak_s = PEAK_OPS_S['bf16']
    results['train'] = {
        'model': 'ssd_mobilenet_v2', 'input': config.input_size,
        'batch': TRAIN_BATCH, 'dtype': str(config.dtype),
        'step_wall_ms': wall, 'step_event_ms': event,
        'images_per_s': TRAIN_BATCH / wall * 1e3,
        'peak_memory_bytes': peak, 'flops_per_step': flops,
        'bf16_peak_share_of_wall': flops / (wall / 1e3 * peak_s),
        'bf16_peak_share_of_busy': flops / (
            summary['device_busy_ms'] / window / 1e3 * peak_s),
        'phase_device_ms': {k: v / 1e3 for k, v in phase_us.items()},
        'profile': summary}
    print('train step ssd_mobilenet_v2 {0}x{0} {1} batch {2}: wall median '
          '{3:.3f} ms, CUDA-event {4:.3f} ms, {5:.1f} images/s, peak memory '
          '{6:.3f} GB; {7:.4g} GFLOP a step (FlopCounterMode), {8:.2%} of '
          'the bf16 dense peak over the wall time, {9:.2%} over the busy '
          'time; device time forward {10:.3f} ms, backward {11:.3f} ms, '
          'optimizer {12:.3f} ms'.format(
              config.input_size, config.dtype, TRAIN_BATCH, wall, event,
              TRAIN_BATCH / wall * 1e3, peak / 1e9, flops / 1e9,
              results['train']['bf16_peak_share_of_wall'],
              results['train']['bf16_peak_share_of_busy'],
              phase_us['forward'] / 1e3, phase_us['backward'] / 1e3,
              phase_us['optimizer'] / 1e3), flush=True)


def profile_sharded_train(results, steps, spec):
    """--path train --mesh DxM: the sharded train step of ssd_mobilenet_v2
    at full width (parallel/fleet.py make_sharded_train_step) over a D x M
    mesh of the visible cards (a card repeats where the mesh has more
    devices), TRAIN_BATCH images a distinct card: its wall time a step and
    images/s, a profiler window of up to 10 steps (each card's busy share and
    device events a step), and each phase's wall time from a window of
    steps synchronized between the phases (forward with the moment
    exchange, backward with the gradient sum, optimizer) with each card's
    device time in it; then the unsharded step on the first card at
    TRAIN_BATCH images, timed the same way."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from watsor_tpu_torch.workload import (TRAIN_BATCH, build_sharded_train,
                                           build_train_state, mesh_devices,
                                           synchronize, timed_train_steps,
                                           train_batch)
    devices, model_parallel = mesh_devices(spec)
    config, state, step, batch, n = build_sharded_train(devices,
                                                        model_parallel)
    cards = sorted({d.index for d in devices})
    timed_train_steps(state, step, batch, 3, devices)
    rows = timed_train_steps(state, step, batch, steps, devices)
    wall = statistics.median(r['wall_ms'] for r in rows)
    print('sharded train step ssd_mobilenet_v2 {0}x{0} {1} mesh {2} over '
          'cards {3}, global batch {4}: wall median {5:.3f} ms, {6:.1f} '
          'images/s'.format(config.input_size, config.dtype, spec, cards, n,
                            wall, n / wall * 1e3), flush=True)

    def card_spans(prof):
        """{card: [(start us, end us, name)]} of the devices' kernels and
        copies."""
        spans = defaultdict(list)
        for e in prof.events():
            if e.device_type.name == 'CUDA' and \
                    not getattr(e, 'is_user_annotation', False):
                spans[e.device_index].append(
                    (e.time_range.start, e.time_range.end, e.name))
        return spans

    window = min(10, steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(window):
            step(state, batch)
        synchronize(devices)
        window_ms = (time.perf_counter() - start) * 1e3
    spans = card_spans(prof)
    busy = {card: (busy_us(spans[card]) / 1e3 / window,
                   len(spans[card]) / window) for card in cards}
    for card, (b, e) in busy.items():
        print('  card {}: device busy {:.3f} ms a step ({:.1%} of the '
              'window), {:.0f} device events a step'.format(
                  card, b, b * window / window_ms, e), flush=True)
    phases = ('forward', 'backward', 'optimizer')
    phase_wall = defaultdict(list)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            for phase in phases:
                t0 = time.perf_counter()
                with record_function('train_' + phase):
                    if phase == 'forward':
                        loss, _ = step.forward(state, batch)
                    elif phase == 'backward':
                        step.backward(state, loss)
                    else:
                        step.update(state)
                    synchronize(devices)
                phase_wall[phase].append((time.perf_counter() - t0) * 1e3)
    # each kernel counted in the phase during whose host range it started
    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name[len('train_'):]) for e in prof.events()
                    if e.device_type.name == 'CPU' and
                    e.name.startswith('train_'))
    starts = [a for a, _, _ in ranges]
    in_phase = defaultdict(lambda: defaultdict(list))
    for card, card_list in card_spans(prof).items():
        for span in card_list:
            k = bisect.bisect_right(starts, span[0]) - 1
            if k >= 0 and span[0] < ranges[k][1]:
                in_phase[ranges[k][2]][card].append(span)
    phase_cards = {phase: {card: busy_us(in_phase[phase][card]) / 1e3 /
                           window for card in cards} for phase in phases}
    for phase in phases:
        print('  {}: wall {:.3f} ms, device {}'.format(
            phase, statistics.median(phase_wall[phase]),
            {c: round(b, 3) for c, b in phase_cards[phase].items()}),
            flush=True)
    del state, step, batch, loss
    torch.cuda.empty_cache()
    _, single, single_step = build_train_state(torch.device('cuda', 0))
    single_batch = {k: torch.as_tensor(v).to('cuda:0') for k, v in
                    train_batch(config.input_size).items()}
    timed_train_steps(single, single_step, single_batch, 3)
    single_wall = statistics.median(
        r['wall_ms'] for r in timed_train_steps(single, single_step,
                                                single_batch, steps))
    print('  one card unsharded at batch {}: wall median {:.3f} ms, {:.1f} '
          'images/s'.format(TRAIN_BATCH, single_wall,
                            TRAIN_BATCH / single_wall * 1e3), flush=True)
    results['train_mesh'] = {
        'mesh': spec, 'devices': [str(d) for d in devices], 'cards': cards,
        'global_batch': n, 'step_wall_ms': wall,
        'images_per_s': n / wall * 1e3, 'window_wall_ms': window_ms,
        'card_busy_ms_per_step': {c: b for c, (b, _) in busy.items()},
        'card_busy_share': {c: b * window / window_ms
                            for c, (b, _) in busy.items()},
        'card_events_per_step': {c: e for c, (_, e) in busy.items()},
        'phase_wall_ms': {k: statistics.median(v)
                          for k, v in phase_wall.items()},
        'phase_card_device_ms': phase_cards,
        'single_card_batch': TRAIN_BATCH, 'single_card_wall_ms': single_wall,
        'single_card_images_per_s': TRAIN_BATCH / single_wall * 1e3}


def _baseline_launcher(tree):
    """A launcher for the fused-block kernel of another checkout ``tree``
    whose csrc/fused_block.cu has the second version's C entry (a launch
    plan from ops/fused_block.py plan_launch)."""
    lib = _build.load('fused_block_baseline', fused_block._SIGNATURES,
                      source=os.path.join(tree, 'watsor_tpu_torch', 'csrc',
                                          'fused_block.cu'))

    def launch(x, args, out, residual):
        B, H, W, C_in = x.shape
        plan = fused_block.plan_launch(B, H, W, C_in, args[0].shape[-1],
                                       args[4].shape[-1])
        fused_block.launch(lib, x, *args, out, residual, plan)
    return launch


# the C entry of the first int8_matmul_requant kernel (one 128 x 64 tile a
# block, no launch plan): x, w, scale, bias, inv, hi, relu6, out,
# out_is_i8, M, K, N, device, stream
_INT8_V1_SIGNATURES = {'wt_int8_matmul_requant': [
    ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                            ctypes.c_void_p] + [ctypes.c_int] * 5 +
    [ctypes.c_void_p]}


def _int8_baseline_launcher(tree):
    """A launcher with the arguments of int8_matmul_requant for the int8
    kernel of another checkout ``tree`` whose csrc/int8_matmul.cu has the
    first version's C entry."""
    from watsor_tpu_torch.ops.int8_matmul import requant_constants
    lib = _build.load('int8_matmul_baseline', _INT8_V1_SIGNATURES,
                      source=os.path.join(tree, 'watsor_tpu_torch', 'csrc',
                                          'int8_matmul.cu'))

    def launch(x, w, scale, bias, out_scale, relu6):
        (M, K), N = x.shape, w.shape[1]
        inv, hi = requant_constants(out_scale)
        out = torch.empty((M, N), device=x.device, dtype=torch.float32
                          if out_scale is None else torch.int8)
        _build.check(lib.wt_int8_matmul_requant(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            float(inv), float(hi), int(relu6), out.data_ptr(),
            int(out_scale is not None), M, K, N, x.device.index,
            torch.cuda.current_stream().cuda_stream), 'baseline int8 kernel')
        return out
    return launch


def profile_blocks(device, results, min_blocks, baseline=None):
    """The 12 fused blocks at batch 8 as device time: the kernel with the
    launch plan of each ``min_blocks`` (the plan's one tunable), the
    kernel of the ``baseline`` checkout if given, the plain version and
    cuDNN's three-convolution block. Kernel versions take turns A B B A."""
    lib = _build.load('fused_block', fused_block._SIGNATURES)
    old = _baseline_launcher(baseline) if baseline else None
    rng = np.random.default_rng(0)
    totals = defaultdict(float)
    rows = []
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
        want = fused_block.fused_inverted_residual_plain(
            x, *args, residual=residual).float()
        out = torch.empty((BATCH, H, H, C_out), dtype=torch.bfloat16,
                          device=device)
        versions = {}
        for m in min_blocks:
            plan = fused_block.plan_launch(BATCH, H, H, C_in, E, C_out,
                                           min_blocks=m)
            versions['min{}'.format(m)] = (
                lambda plan=plan: fused_block.launch(lib, x, *args, out,
                                                     residual, plan))
        if old is not None:
            versions['baseline'] = lambda: old(x, args, out, residual)
        row = {'shape': [H, C_in, E, C_out]}
        times = defaultdict(list)
        for name in list(versions) + list(versions)[::-1]:
            times[name].append(graph_ms(versions[name]))
        for name, run in versions.items():
            run()
            torch.cuda.synchronize()
            row[name + '_ms'] = statistics.mean(times[name])
            row[name + '_max_err'] = float((out.float() - want).abs().max())
            totals[name] += row[name + '_ms']
        row['plain_ms'] = graph_ms(lambda: fused_block
                                   .fused_inverted_residual_plain(
                                       x, *args, residual=residual))
        row['cudnn_ms'] = graph_ms(cudnn_block(x, *args, residual))
        for name in ('plain', 'cudnn'):
            totals[name] += row[name + '_ms']
        rows.append(row)
        print('block {}x{} {}->{}->{}: {} | plain {:.4f} ms | cuDNN {:.4f} '
              'ms'.format(H, H, C_in, E, C_out, ', '.join(
                  '{} {:.4f} ms (max err {:.3g})'.format(
                      name, row[name + '_ms'], row[name + '_max_err'])
                  for name in versions), row['plain_ms'], row['cudnn_ms']),
              flush=True)
    results['blocks'] = rows
    results['blocks_total_ms'] = dict(totals)
    print('12 blocks on the device: ' + ', '.join(
        '{} {:.4f} ms'.format(k, v) for k, v in totals.items()), flush=True)


def profile_launch_cost(device, results):
    """Host time of one wrapper launch: the first fused block's shape and
    the suppression at the main path's C = 2."""
    from watsor_tpu_torch.ops.nms_fixed_point import fixed_point_suppress
    rng = np.random.default_rng(0)
    H, C_in, E, C_out = FUSED_SHAPES[0]

    def rand(shape, scale, dtype):
        return torch.tensor(rng.normal(0, scale, shape), dtype=dtype,
                            device=device)
    x = rand((BATCH, H, H, C_in), 1.0, torch.bfloat16)
    args = (rand((C_in, E), 0.2, torch.bfloat16),
            rand((E,), 0.1, torch.float32),
            rand((3, 3, E), 0.3, torch.bfloat16),
            rand((E,), 0.1, torch.float32),
            rand((E, C_out), 0.1, torch.bfloat16),
            rand((C_out,), 0.1, torch.float32))
    block_us = host_us(lambda: fused_block.fused_inverted_residual(
        x, *args, residual=True))
    yx = rng.uniform(0, 1, (BATCH, 128, 2))
    boxes = torch.tensor(np.concatenate([yx, yx + 0.1], -1),
                         dtype=torch.float32, device=device)
    scores = torch.tensor(rng.uniform(0, 1, (BATCH, 2, 128)),
                          dtype=torch.float32, device=device)
    nms_us = host_us(lambda: fixed_point_suppress(scores, boxes, 0.6))
    results['launch_host_us'] = {'fused_inverted_residual': block_us,
                                 'fixed_point_suppress': nms_us}
    print('host time a launch: fused_inverted_residual {:.2f} us, '
          'fixed_point_suppress {:.2f} us'.format(block_us, nms_us),
          flush=True)


def profile_int8_kernels(device, results, baseline=None):
    """The int8 path's kernels against their plain versions as device
    time: one row for each distinct shape of one forward's 38
    int8_matmul_requant calls (the kernel, the ``baseline`` checkout's
    kernel in turns A B B A, the plain version, torch._int_mm alone and
    with the epilogue as PyTorch ops, the bound, the launch plan),
    totals weighted by how often the forward calls each shape, and the
    per-class suppression at B = 8, K = 100."""
    import collections
    from watsor_tpu_torch.ops import int8_matmul, nms_suppress
    from watsor_tpu_torch.workload import int8_pointwise_calls
    rng = np.random.default_rng(0)
    old = _int8_baseline_launcher(baseline) if baseline else None
    totals = defaultdict(float)
    rows = []
    for (M, K, N, quantize, relu6), n in collections.Counter(
            int8_pointwise_calls(BATCH)).items():
        x = torch.tensor(rng.integers(-127, 128, (M, K)), dtype=torch.int8,
                         device=device)
        w = torch.tensor(rng.integers(-127, 128, (K, N)), dtype=torch.int8,
                         device=device)
        scale = torch.tensor(rng.uniform(1.5e-4, 4.5e-4, N) / K ** 0.5,
                             dtype=torch.float32, device=device)
        bias = torch.tensor(rng.normal(0, 0.5, N), dtype=torch.float32,
                            device=device)
        out_scale = 0.047 if quantize else None
        args = (x, w, scale, bias, out_scale, relu6)
        want = int8_matmul.int8_matmul_requant_plain(*args)
        versions = {'kernel': lambda: int8_matmul.int8_matmul_requant(*args)}
        if old is not None:
            versions['baseline'] = lambda: old(*args)
        row = {'shape': [M, K, N], 'out': 'int8' if quantize else 'f32',
               'relu6': relu6, 'calls': n}
        times = defaultdict(list)
        for name in list(versions) + list(versions)[::-1]:
            times[name].append(graph_ms(versions[name]))
        for name, run in versions.items():
            row[name + '_ms'] = statistics.mean(times[name])
            row[name + '_identical'] = bool(torch.equal(run(), want))
        row['plain_ms'] = graph_ms(
            lambda: int8_matmul.int8_matmul_requant_plain(*args), n=3, reps=5)
        w_mm, row['int_mm_w'] = int_mm_operand(x, w)
        row['int_mm_ms'] = graph_ms(lambda: torch._int_mm(x, w_mm))
        inv, hi = int8_matmul.requant_constants(out_scale)
        scale_inv, bias_inv = scale * float(inv), bias * float(inv)

        def int_mm_epilogue():
            y = torch._int_mm(x, w_mm).float() * scale_inv + bias_inv
            if relu6:
                y = y.clamp(0.0, float(hi))
            if quantize:
                y = y.round().clamp(-127.0, 127.0).to(torch.int8)
            return y
        row['int_mm_epilogue_ms'] = graph_ms(int_mm_epilogue)
        nbytes, ops = int8_call_work(M, K, N, quantize)
        row['bound_ms'] = Bound().add(nbytes, int8=ops).ms
        row['plan'] = int8_matmul.plan_launch(M, K, N)._asdict()
        for key in ('kernel', 'baseline', 'plain', 'int_mm',
                    'int_mm_epilogue', 'bound'):
            if key + '_ms' in row:
                totals[key] += n * row[key + '_ms']
        rows.append(row)
        print('int8_matmul_requant M={} K={} N={} {}{} x{}: {} | plain '
              '{:.4f} | _int_mm {:.4f} ({}) | _int_mm+epilogue {:.4f} | '
              'bound {:.4f} ms; plan {}'.format(
                  M, K, N, row['out'], ' relu6' if relu6 else '', n,
                  ', '.join('{} {:.4f} ms{}'.format(
                      name, row[name + '_ms'],
                      '' if row[name + '_identical'] else ' (DIFFERS)')
                      for name in versions),
                  row['plain_ms'], row['int_mm_ms'], row['int_mm_w'],
                  row['int_mm_epilogue_ms'], row['bound_ms'],
                  ' '.join('{}={}'.format(k, v)
                           for k, v in row['plan'].items())), flush=True)
    results['int8_matmul_shapes'] = rows
    results['int8_matmul_forward_device_ms'] = dict(totals)
    print('38 int8_matmul_requant calls of a forward on the device: ' +
          ', '.join('{} {:.4f} ms'.format(k, v) for k, v in totals.items()),
          flush=True)
    for C in (2, 90):
        yx = rng.uniform(0, 1, (BATCH, C, 100, 2))
        boxes = torch.tensor(np.concatenate([yx, yx + 0.1], -1),
                             dtype=torch.float32, device=device)
        scores = torch.tensor(-np.sort(-rng.uniform(0, 1, (BATCH, C, 100))),
                              dtype=torch.float32, device=device)
        kernel = graph_ms(lambda: nms_suppress.pallas_suppress(
            boxes, scores, 0.6))
        plain = graph_ms(lambda: nms_suppress.pallas_suppress_plain(
            boxes, scores, 0.6), n=2, reps=3)
        results['pallas_suppress_device_ms_C{}'.format(C)] = {
            'kernel': kernel, 'plain': plain}
        print('pallas_suppress B={} C={} K=100 on the device: kernel {:.4f} '
              'ms, plain {:.4f} ms'.format(BATCH, C, kernel, plain),
              flush=True)


def profile_int8_plans(device, results):
    """Every launch plan the int8 kernel takes (ops/int8_matmul.py
    candidate_plans) at each distinct shape of one int8 forward, as device
    time, beside the plan that plan_launch picks: the sweep its rule was
    fitted to."""
    from watsor_tpu_torch.ops import int8_matmul
    from watsor_tpu_torch.workload import int8_pointwise_calls
    lib = _build.load('int8_matmul', int8_matmul._SIGNATURES)
    rng = np.random.default_rng(0)
    rows = []
    for M, K, N, quantize, relu6 in sorted(set(int8_pointwise_calls(BATCH))):
        x = torch.tensor(rng.integers(-127, 128, (M, K)), dtype=torch.int8,
                         device=device)
        w = torch.tensor(rng.integers(-127, 128, (K, N)), dtype=torch.int8,
                         device=device)
        scale = torch.full((N,), 3e-4 / K ** 0.5, device=device)
        bias = torch.zeros(N, device=device)
        out_scale = 0.047 if quantize else None
        out = torch.empty((M, N), device=device, dtype=torch.int8
                          if quantize else torch.float32)
        want = int8_matmul.int8_matmul_requant_plain(x, w, scale, bias,
                                                     out_scale, relu6)
        timed = []
        for plan in int8_matmul.candidate_plans(M, K, N):
            def run(plan=plan):
                int8_matmul.launch(lib, x, w, scale, bias, out, out_scale,
                                   relu6, plan)
            run()
            if not torch.equal(out, want):
                raise AssertionError('int8 plan {} differs at {}'.format(
                    plan, (M, K, N)))
            timed.append((graph_ms(run), plan))
        chosen = int8_matmul.plan_launch(M, K, N)
        best_ms, best = min(timed)
        chosen_ms = next(ms for ms, p in timed if p == chosen)
        rows.append({'shape': [M, K, N], 'out': 'int8' if quantize
                     else 'f32', 'chosen': chosen._asdict(),
                     'chosen_ms': chosen_ms, 'best': best._asdict(),
                     'best_ms': best_ms,
                     'plans': [[ms, p.bm, p.splits, p.tiles, p.blocks]
                               for ms, p in timed]})
        print('plans M={} K={} N={}: chosen bm {} S {} tiles {} {:.4f} ms, '
              'best bm {} S {} tiles {} {:.4f} ms of {}'
              .format(M, K, N, chosen.bm, chosen.splits, chosen.tiles,
                      chosen_ms, best.bm, best.splits, best.tiles, best_ms,
                      len(timed)),
              flush=True)
    results['int8_plan_sweep'] = rows


def profile_launch_cost_int8(device, results):
    """Host time of one wrapper launch on the int8 path: its first
    pointwise unit and the per-class suppression at C = 2, K = 100."""
    from watsor_tpu_torch.ops.int8_matmul import int8_matmul_requant
    from watsor_tpu_torch.ops.nms_suppress import pallas_suppress
    from watsor_tpu_torch.workload import int8_pointwise_calls
    rng = np.random.default_rng(0)
    M, K, N, _, relu6 = int8_pointwise_calls(BATCH)[0]
    x = torch.tensor(rng.integers(-127, 128, (M, K)), dtype=torch.int8,
                     device=device)
    w = torch.tensor(rng.integers(-127, 128, (K, N)), dtype=torch.int8,
                     device=device)
    scale = torch.full((N,), 1e-4, device=device)
    bias = torch.zeros(N, device=device)
    mm_us = host_us(lambda: int8_matmul_requant(x, w, scale, bias, 0.05,
                                                relu6))
    yx = rng.uniform(0, 1, (BATCH, 2, 100, 2))
    boxes = torch.tensor(np.concatenate([yx, yx + 0.1], -1),
                         dtype=torch.float32, device=device)
    scores = torch.tensor(-np.sort(-rng.uniform(0, 1, (BATCH, 2, 100))),
                          dtype=torch.float32, device=device)
    nms_us = host_us(lambda: pallas_suppress(boxes, scores, 0.6))
    results['launch_host_us'] = {'int8_matmul_requant': mm_us,
                                 'pallas_suppress': nms_us}
    print('host time a launch: int8_matmul_requant {:.2f} us, '
          'pallas_suppress {:.2f} us'.format(mm_us, nms_us), flush=True)


# the entry points of a suppression kernel built with WT_PHASE_CLOCK
_PHASE_SIGNATURES = {
    'wt_phase_stamps': [ctypes.c_void_p, ctypes.c_int],
    'wt_empty_kernel': [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]}
_STAMPS = 6                       # kStamps of the kernels' sources


def phase_split(lib, run, blocks, phases, reps=20):
    """Per-phase time of a kernel built with WT_PHASE_CLOCK: ``run``
    launches it once over ``blocks`` blocks; each block stamps
    %globaltimer and clock64 at len(phases) + 1 boundaries. Returns, as
    medians over ``reps`` launches, each phase's median and largest time
    over the blocks (ns from %globaltimer, and cycles), and the span from
    the first block's start to the last block's end."""
    stamps = np.zeros((blocks, 2 * _STAMPS), np.uint64)
    _build.check(lib.wt_phase_stamps(stamps.ctypes.data, blocks), 'stamps')
    n = len(phases) + 1
    rows = defaultdict(list)
    for _ in range(reps):
        run()
        torch.cuda.synchronize()
        _build.check(lib.wt_phase_stamps(stamps.ctypes.data, blocks),
                     'stamps')
        ns = stamps[:, :n].astype(np.int64)
        cycles = stamps[:, _STAMPS:_STAMPS + n].astype(np.int64)
        if (ns == 0).any():
            raise AssertionError('a block missed a phase stamp')
        for p, name in enumerate(phases):
            d_ns = ns[:, p + 1] - ns[:, p]
            d_cyc = cycles[:, p + 1] - cycles[:, p]
            rows[name + '_ns'].append(float(np.median(d_ns)))
            rows[name + '_max_ns'].append(float(d_ns.max()))
            rows[name + '_cycles'].append(float(np.median(d_cyc)))
            rows[name + '_max_cycles'].append(float(d_cyc.max()))
        rows['span_ns'].append(float(ns[:, -1].max() - ns[:, 0].min()))
        rows['block_ns'].append(float(np.median(ns[:, -1] - ns[:, 0])))
        rows['block_cycles'].append(float(np.median(cycles[:, -1] -
                                                    cycles[:, 0])))
    return {k: statistics.median(v) for k, v in rows.items()}


def _empty_launch(lib, grid_x, grid_y, threads):
    def run():
        _build.check(lib.wt_empty_kernel(
            grid_x, grid_y, threads,
            torch.cuda.current_stream().cuda_stream), 'empty kernel')
    return run


def _suppression_inputs(rng, B, C, M, per_class, device):
    """chip_smoke.py's suppression inputs: scores on a 1/64 grid (many
    ties), boxes of side 0.02 to 0.4; per class sorted when ``per_class``
    (kernel 3's top-k), else one set of boxes an image (kernel 1's
    union)."""
    s = np.floor(rng.uniform(0, 1, (B, C, M)) * 64) / 64
    shape = (B, C, M) if per_class else (B, M)
    if per_class:
        s = -np.sort(-s, axis=-1)
    yx = rng.uniform(0, 1, shape + (2,))
    hw = rng.uniform(0.02, 0.4, shape + (2,))
    boxes = np.concatenate([yx, yx + hw], -1)
    return (torch.tensor(s, dtype=torch.float32, device=device),
            torch.tensor(boxes, dtype=torch.float32, device=device))


def _report(results, key, row, text):
    results[key] = row
    print(text + ': ' + ', '.join(
        '{} {:.4g}'.format(k, v) if isinstance(v, float) else
        '{} {}'.format(k, v) for k, v in row.items()), flush=True)


def _suppression_libraries(name, signatures, tree=None):
    """(timing build, phase-clock build or None) of csrc/<name>.cu, this
    tree's or the checkout ``tree``'s; the phase-clock build exists where
    the source has WT_PHASE_CLOCK."""
    if tree:
        source = os.path.join(tree, 'watsor_tpu_torch', 'csrc', name + '.cu')
        name += '_baseline'
    else:
        source = os.path.join(_build.CSRC_DIR, name + '.cu')
    timing = _build.load(name, signatures, source=source)
    with open(source) as f:
        if 'WT_PHASE_CLOCK' not in f.read():
            return timing, None
    return timing, _build.load(name + '_phases',
                               dict(signatures, **_PHASE_SIGNATURES),
                               source=source, defines=('WT_PHASE_CLOCK',))


def fixed_point_v1(tree):
    """Kernel 1 of another checkout whose csrc/nms_fixed_point.cu has the
    first version's C entry (an IoU matrix where the second takes the
    boxes): a function of (scores_cm, boxes, iou_threshold) that builds
    ``iou_matrix`` and launches it, as the first version's stage did."""
    from watsor_tpu_torch.ops import nms_fixed_point
    from watsor_tpu_torch.ops.boxes import iou_matrix
    lib, _ = _suppression_libraries('nms_fixed_point',
                                    nms_fixed_point._SIGNATURES, tree)

    def suppress(scores_cm, boxes, iou_threshold=0.6):
        keep = torch.empty(scores_cm.shape, dtype=torch.bool,
                           device=scores_cm.device)
        nms_fixed_point.launch(lib, scores_cm, iou_matrix(boxes, boxes),
                               keep, iou_threshold)
        return keep
    return suppress


def _turns(versions):
    """Device time of each version, in turns A B B A; the mean of each."""
    times = defaultdict(list)
    for name in list(versions) + list(versions)[::-1]:
        times[name].append(graph_ms(versions[name]))
    return {name + '_device_ms': statistics.mean(t)
            for name, t in times.items()}


def profile_nms(device, results, baseline=None):
    """The two suppression kernels at the paths' shapes (kernel 1 at
    [8, C, 128], kernel 3 at [8, C, 100]; C = 2 and 90), each checked
    against its plain version: device time (CUDA-graph replay) and
    CUDA-event time with host launches; the ``baseline`` checkout's kernels
    (the first versions) in turns A B B A, kernel 1 with the
    ``iou_matrix`` it reads; an empty kernel launched with the second
    version's grid; and the phase split of each version's WT_PHASE_CLOCK
    build."""
    from watsor_tpu_torch.ops import nms_fixed_point, nms_suppress
    from watsor_tpu_torch.ops.boxes import iou_matrix
    rng = np.random.default_rng(0)

    fp, fp_phases = _suppression_libraries('nms_fixed_point',
                                           nms_fixed_point._SIGNATURES)
    if baseline:
        fp_old, fp_old_phases = _suppression_libraries(
            'nms_fixed_point', nms_fixed_point._SIGNATURES, baseline)
    for C in (2, 90):
        scores, boxes = _suppression_inputs(rng, BATCH, C, 128, False,
                                            device)
        iou = iou_matrix(boxes, boxes)
        want = nms_fixed_point.fixed_point_suppress_plain(scores, boxes, 0.6)
        keep = torch.empty_like(want)

        def v2(lib=fp, scores=scores, boxes=boxes, keep=keep):
            nms_fixed_point.launch(lib, scores, boxes, keep, 0.6)
        versions = {'v2': v2}
        v2()
        checks = {'v2': torch.equal(keep, want)}
        row = {'kept': int(want.sum()), 'blocks': BATCH * C}
        if baseline:
            def v1(lib=fp_old, scores=scores, boxes=boxes, keep=keep):
                nms_fixed_point.launch(lib, scores, iou_matrix(boxes, boxes),
                                       keep, 0.6)

            def v1_alone(lib=fp_old, scores=scores, iou=iou, keep=keep):
                nms_fixed_point.launch(lib, scores, iou, keep, 0.6)
            versions['v1_with_iou'] = v1
            v1()
            checks['v1'] = torch.equal(keep, want)
            row['v1_alone_device_ms'] = graph_ms(v1_alone)
        if not all(checks.values()):
            raise AssertionError('kernel 1 differs from its plain version: '
                                 '{}'.format(checks))
        row.update(_turns(versions))
        for name, run in versions.items():
            row[name + '_events_ms'] = events_ms(run)
        empty = _empty_launch(fp_phases, BATCH * C, 1, 512)
        row.update(empty_device_ms=graph_ms(empty),
                   empty_events_ms=events_ms(empty))
        for prefix, lib, phases, run in (
                ('v2_', fp_phases, ('load', 'rank', 'triangle', 'walk',
                                    'write'), v2),
                ('v1_', fp_old_phases if baseline else None,
                 ('bitmask', 'walk'), v1_alone if baseline else None)):
            if lib is not None:
                blocks = BATCH * C if prefix == 'v2_' else \
                    BATCH * ((C + 7) // 8)
                row.update({prefix + k: v for k, v in phase_split(
                    lib, lambda lib=lib, run=run: run(lib=lib), blocks,
                    phases).items()})
        _report(results, 'fixed_point_suppress_C{}'.format(C), row,
                'fixed_point_suppress B={} C={} M=128'.format(BATCH, C))

    sup, sup_phases = _suppression_libraries('nms_suppress',
                                             nms_suppress._SIGNATURES)
    if baseline:
        sup_old, sup_old_phases = _suppression_libraries(
            'nms_suppress', nms_suppress._SIGNATURES, baseline)
    for C in (2, 90):
        scores, boxes = _suppression_inputs(rng, BATCH, C, 100, True,
                                            device)
        want = nms_suppress.pallas_suppress_plain(boxes, scores, 0.6)
        out = torch.empty_like(want)

        def run(lib, scores=scores, boxes=boxes, out=out):
            nms_suppress.launch(lib, boxes, scores, out, 0.6)
        versions = {'v2': lambda run=run: run(sup)}
        if baseline:
            versions['v1'] = lambda run=run: run(sup_old)
        checks = {}
        for name, version in versions.items():
            version()
            checks[name] = torch.equal(out, want)
        if not all(checks.values()):
            raise AssertionError('kernel 3 differs from its plain version: '
                                 '{}'.format(checks))
        row = {'kept': int((want > 0).sum()), 'blocks': BATCH * C}
        row.update(_turns(versions))
        for name, version in versions.items():
            row[name + '_events_ms'] = events_ms(version)
        empty = _empty_launch(sup_phases, BATCH * C, 1, 512)
        row.update(empty_device_ms=graph_ms(empty),
                   empty_events_ms=events_ms(empty))
        for prefix, lib, phases in (
                ('v2_', sup_phases, ('stage', 'triangle', 'walk', 'write')),
                ('v1_', sup_old_phases if baseline else None,
                 ('stage', 'triangle', 'walk'))):
            if lib is not None:
                row.update({prefix + k: v for k, v in phase_split(
                    lib, lambda lib=lib, run=run: run(lib), BATCH * C,
                    phases).items()})
        _report(results, 'pallas_suppress_C{}'.format(C), row,
                'pallas_suppress B={} C={} K=100'.format(BATCH, C))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--path',
                        choices=('main', 'int8', 'nms', 'fleet', 'train',
                                 'app'),
                        default='main',
                        help='the main path (fused walk), the int8 path, '
                             'the two suppression kernels alone, the '
                             'fleet and the device overlay, the train '
                             'step, or the application under bench app')
    parser.add_argument('--model', default=None,
                        help='instead of a path, profile these families of '
                             'the zoo (comma list; "all" for every family '
                             'of chip_smoke.py phase 4)')
    parser.add_argument('--min-blocks', default=str(fused_block.MIN_BLOCKS),
                        help='fused-block launch plans to time: values of '
                             'the plan\'s MIN_BLOCKS, comma list')
    parser.add_argument('--baseline', default=None,
                        help='a checkout whose kernel of the path is timed '
                             'beside this one\'s: its fused-block kernel '
                             '(with a launch plan) on the main path, its '
                             'first int8 kernel on the int8 path')
    parser.add_argument('--int8-plans', action='store_true',
                        help='int8 path: also time every launch plan of '
                             'the int8 kernel at each of its shapes')
    parser.add_argument('--pool-only', action='store_true',
                        help='fleet path: only the mesh over every visible '
                             'card (for a run on several cards)')
    parser.add_argument('--mesh', default=None,
                        help='train path: the sharded step over a DxM '
                             '(data x model) mesh of the visible cards, '
                             'e.g. 2x2')
    parser.add_argument('--steps', type=int, default=30,
                        help='backend steps timed per turn')
    parser.add_argument('--trace', default=None,
                        help='write the torch.profiler window here (Chrome '
                             'trace JSON)')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_step needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    card = card_label(device)
    print(card, flush=True)
    print('torch {}, CUDA {}'.format(torch.__version__, torch.version.cuda),
          flush=True)
    results = {'card': card, 'batch': BATCH, 'path': args.path}
    if args.model:
        from watsor_tpu_torch.workload import FAMILIES
        names = FAMILIES if args.model == 'all' else args.model.split(',')
        results['path'] = 'models'
        for name in names:
            profile_family(device, results, name.strip())
            torch.cuda.empty_cache()
        print(json.dumps(results), flush=True)
        return
    if args.path in ('nms', 'fleet', 'train', 'app'):
        if args.path == 'nms':
            profile_nms(device, results, args.baseline)
        elif args.path == 'app':
            profile_app(device, results)
        elif args.path == 'train' and args.mesh:
            results['cards'] = torch.cuda.device_count()
            profile_sharded_train(results, args.steps, args.mesh)
        elif args.path == 'train':
            profile_train(device, results, args.steps, args.trace)
        else:
            results['cards'] = torch.cuda.device_count()
            profile_fleet(device, results, args.steps, args.pool_only)
        print(json.dumps(results), flush=True)
        return
    prof = profile_models(device, results, args.steps, args.path,
                          fixed_point_v1(args.baseline)
                          if args.baseline and args.path == 'main' else None)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if args.path == 'main':
        profile_blocks(device, results,
                       [int(m) for m in args.min_blocks.split(',')
                        if m.strip()], args.baseline)
        profile_launch_cost(device, results)
    else:
        profile_int8_kernels(device, results, args.baseline)
        if args.int8_plans:
            profile_int8_plans(device, results)
        profile_launch_cost_int8(device, results)
    print(json.dumps(results), flush=True)


if __name__ == '__main__':
    main()
