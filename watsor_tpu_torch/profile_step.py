"""Step profile of the port's main path on one CUDA card.

    python -m watsor_tpu_torch.profile_step [--path main|int8]
                                            [--chunks 32,48,64]
                                            [--trace step_trace.json]

Drives a workload of chip_smoke.py (``watsor_tpu_torch.workload``) at
batch 8 and prints a line per measurement, then all of them as one JSON
object on the last line. ``--path main`` (the default) profiles the fused
walk with ``nms: fused_exact``; ``--path int8`` the int8 walk
(int8_full, pointwise units through the kernel) with ``nms: exact``:

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
- main path: the 12 fused blocks as device time, the kernel at each
  chunk width of ``--chunks`` (built with ``-DWT_FUSED_CHUNK``) against
  the plain version; int8 path: the 38 int8_matmul_requant calls of one
  forward and the per-class suppression at C = 2 and C = 90, kernel
  against plain version, as device time;
- the host's cost of one launch through each of the path's kernel
  wrappers (checks, output allocation, the ctypes call), at its shapes.

Every time is a median. The card's name and power limit head the output;
compare numbers only within one run.
"""

import argparse
import json
import statistics
import subprocess
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
from watsor_tpu_torch.workload import (BATCH, FRAME_HW, FUSED_SHAPES,
                                       build_int8_path_detector,
                                       build_main_path_detector,
                                       calibration_frames, camera_filters)


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


def profile_models(device, results, steps, path='main'):
    """Plain against the path's walk, NMS and the whole step; returns the
    profiler window of the path's backend steps."""
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

    return profile_trace(backend(walk), images, cameras, results, name)


def profile_trace(be, images, cameras, results, label, steps=10, top=12):
    """torch.profiler over ``steps`` backend steps; returns the profiler."""
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
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type.name == 'CUDA')
    busy_us, cur_start, cur_end = 0.0, None, None
    per_kernel = defaultdict(lambda: [0, 0.0])
    for s, e, name in spans:
        per_kernel[name][0] += 1
        per_kernel[name][1] += e - s
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    total_us = sum(t for _, t in per_kernel.values()) or 1.0
    kernels = [{'name': name[:80], 'calls': n, 'us_per_call': t / n,
                'share': t / total_us}
               for name, (n, t) in sorted(per_kernel.items(),
                                          key=lambda kv: -kv[1][1])[:top]]
    results['profile'] = {'steps': steps, 'wall_ms': wall,
                          'device_busy_ms': busy_us / 1e3,
                          'busy_share': busy_us / 1e3 / wall,
                          'device_events_per_step': len(spans) / steps,
                          'top_kernels': kernels}
    print('torch.profiler, {} {} steps: wall {:.3f} ms, device busy '
          '{:.3f} ms ({:.1%}), {:.0f} device events a step'.format(
              steps, label, wall, busy_us / 1e3, busy_us / 1e3 / wall,
              len(spans) / steps), flush=True)
    for k in kernels:
        print('  {:6.1%} {:5d} x {:9.2f} us  {}'.format(
            k['share'], k['calls'], k['us_per_call'], k['name']))
    return prof


def profile_blocks(device, results, chunks):
    """The 12 fused blocks at batch 8: each chunk width against plain."""
    libs = {c: _build.load('fused_block', fused_block._SIGNATURES,
                           defines=('WT_FUSED_CHUNK={}'.format(c),))
            for c in chunks}
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
        row = {'shape': [H, C_in, E, C_out]}
        times = defaultdict(list)
        for c in list(chunks) + list(chunks)[::-1]:     # A B C C B A
            times[c].append(graph_ms(lambda: fused_block.launch(
                libs[c], x, *args, out, residual)))
        for c in chunks:
            fused_block.launch(libs[c], x, *args, out, residual)
            torch.cuda.synchronize()
            row['chunk{}_ms'.format(c)] = statistics.mean(times[c])
            row['chunk{}_max_err'.format(c)] = float(
                (out.float() - want).abs().max())
            totals['chunk{}'.format(c)] += row['chunk{}_ms'.format(c)]
        row['plain_ms'] = graph_ms(lambda: fused_block
                                   .fused_inverted_residual_plain(
                                       x, *args, residual=residual))
        totals['plain'] += row['plain_ms']
        rows.append(row)
        print('block {}x{} {}->{}->{}: {} | plain {:.4f} ms'.format(
            H, H, C_in, E, C_out, ', '.join(
                'chunk {} {:.4f} ms (max err {:.3g})'.format(
                    c, row['chunk{}_ms'.format(c)],
                    row['chunk{}_max_err'.format(c)]) for c in chunks),
            row['plain_ms']), flush=True)
    results['blocks'] = rows
    results['blocks_total_ms'] = dict(totals)
    print('12 blocks on the device: ' + ', '.join(
        '{} {:.4f} ms'.format(k, v) for k, v in totals.items()), flush=True)


def profile_launch_cost(device, results):
    """Host time of one wrapper launch: the first fused block's shape and
    the suppression at the main path's C = 2."""
    from watsor_tpu_torch.ops.boxes import iou_matrix
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
    iou = iou_matrix(boxes, boxes).contiguous()
    nms_us = host_us(lambda: fixed_point_suppress(scores, iou, 0.6))
    results['launch_host_us'] = {'fused_inverted_residual': block_us,
                                 'fixed_point_suppress': nms_us}
    print('host time a launch: fused_inverted_residual {:.2f} us, '
          'fixed_point_suppress {:.2f} us'.format(block_us, nms_us),
          flush=True)


def profile_int8_kernels(device, results):
    """The int8 path's kernels against their plain versions as device
    time: one forward's 38 int8_matmul_requant calls (each distinct shape
    timed once and counted as often as the forward calls it) and the
    per-class suppression at B = 8, K = 100."""
    import collections
    from watsor_tpu_torch.ops import int8_matmul, nms_suppress
    from watsor_tpu_torch.workload import int8_pointwise_calls
    rng = np.random.default_rng(0)
    totals = defaultdict(float)
    for (M, K, N, quantize, relu6), n in collections.Counter(
            int8_pointwise_calls(BATCH)).items():
        args = (torch.tensor(rng.integers(-127, 128, (M, K)),
                             dtype=torch.int8, device=device),
                torch.tensor(rng.integers(-127, 128, (K, N)),
                             dtype=torch.int8, device=device),
                torch.full((N,), 3e-4 / K ** 0.5, device=device),
                torch.zeros(N, device=device), 0.047 if quantize else None,
                relu6)
        totals['kernel'] += n * graph_ms(
            lambda: int8_matmul.int8_matmul_requant(*args))
        totals['plain'] += n * graph_ms(
            lambda: int8_matmul.int8_matmul_requant_plain(*args))
    results['int8_matmul_forward_device_ms'] = dict(totals)
    print('38 int8_matmul_requant calls of a forward on the device: kernel '
          '{:.4f} ms, plain {:.4f} ms'.format(totals['kernel'],
                                              totals['plain']), flush=True)
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--path', choices=('main', 'int8'), default='main',
                        help='the main path (fused walk) or the int8 path')
    parser.add_argument('--chunks', default='48',
                        help='fused-block chunk widths to time, comma list '
                             '(multiples of 16)')
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
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else 'nvidia-smi printed nothing'
    print(card, flush=True)
    print('torch {}, CUDA {}'.format(torch.__version__, torch.version.cuda),
          flush=True)
    results = {'card': card, 'batch': BATCH, 'path': args.path}
    prof = profile_models(device, results, args.steps, args.path)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if args.path == 'main':
        profile_blocks(device, results,
                       [int(c) for c in args.chunks.split(',') if c.strip()])
        profile_launch_cost(device, results)
    else:
        profile_int8_kernels(device, results)
        profile_launch_cost_int8(device, results)
    print(json.dumps(results), flush=True)


if __name__ == '__main__':
    main()
