"""Step profile of the port's main path on one CUDA card.

    python -m watsor_tpu_torch.profile_step [--path main|int8]
                                            [--min-blocks 132,264]
                                            [--baseline OTHER_CHECKOUT]
                                            [--int8-plans]
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
  wrappers (checks, output allocation, the ctypes call), at its shapes.

``--baseline`` takes another checkout, unpacked with ``git archive``, and
builds its kernel of the path from its ``csrc/`` beside this one's: on the
main path its fused-block kernel, bound with the C entry of the second
version (a launch plan from ``ops/fused_block.py plan_launch``); on the
int8 path its int8 kernel, bound with the C entry of the first version
(no plan). Versions take turns A B B A.

Every time is a median. The card's name and power limit head the output;
compare numbers only within one run.
"""

import argparse
import ctypes
import json
import os
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
from watsor_tpu_torch.workload import (BATCH, FRAME_HW, FUSED_SHAPES, Bound,
                                       build_int8_path_detector,
                                       build_main_path_detector,
                                       calibration_frames, camera_filters,
                                       cudnn_block, int8_call_work,
                                       int_mm_operand)


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--path', choices=('main', 'int8'), default='main',
                        help='the main path (fused walk) or the int8 path')
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
