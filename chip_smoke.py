#!/usr/bin/env python3
"""Drive the PyTorch port of watsor-tpu once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It builds the port's four CUDA kernels from
``watsor_tpu_torch/csrc/`` (one nvcc each, all at once), then:

1. holds each kernel against its plain PyTorch version at its path's
   shapes (fixed_point_suppress, from the union's boxes, at C = 2, C = 90
   and a ragged M, and pallas_suppress at C = 2 and C = 90, bit for bit;
   int8_matmul_requant bit for bit; fused_inverted_residual within a
   stated tolerance), times both with CUDA events, times cuDNN's
   three-convolution block beside fused_inverted_residual at each of its
   12 shapes, and works out each kernel's bound (the least time the card
   could take for its work);
2. drives the detection main path (ssd_mobilenet_v2 at 300x300, bf16,
   nms fused_exact, fused blocks, device filters) through
   TorchDetectorBackend inside an ObjectDetector fed from FrameBuffers of
   1920x1080 frames, checks what it wrote and that both of its kernels
   ran (12 fused_inverted_residual launches a forward), holds the step's
   raw outputs against the f32 plain model, and prints the f32 plain
   model's TF32 gap (raw outputs with TF32 on against off);
   then the int8 path the same way (WATSOR_QUANTIZE=int8_full,
   WATSOR_INT8_POINTWISE=pallas, calibrated on seeded frames, nms exact),
   with 38 int8_matmul_requant launches a forward and the raw outputs'
   cosine against the f32 plain model;
3. boots TorchApplication on config/config.yaml and waits for detections
   to flow through /metrics, once on the main path and once on the int8
   path with ``nms: exact``, then with ``model: efficientdet_lite0``, the
   default NMS and 8 synthetic cameras;
4. builds each other family of the zoo at full width on the card
   (ssd_mobilenet_v1, ssdlite_mobilenet_v2, ssd_inception_v2,
   efficientdet_lite0..4; bf16, ``nms: fused_exact``, all 90 classes),
   runs its detect step on 8 frames of 1920x1080 with one
   fixed_point_suppress launch a step, holds that launch's keep-mask bit
   for bit against the plain version on the same inputs and the bf16 raw
   outputs against the f32 plain model (TF32 off), and times the step
   from a CUDA-graph replay; then efficientdet_lite0 under ``nms: exact``,
   holding its pallas_suppress launch the same way;
5. the fleet and the device overlay (WATSOR_FLEET, WATSOR_DEVICE_RENDER):
   a. render_boxes at [16, 1080, 1920, 3] with 100 box slots a frame (30
      valid), bit-identical to its CPU result with TF32 off and on, timed
      in both modes against its bound (the frames' bytes in and out); then
      a DeviceRenderer round of 16 concurrent 1080p requests (H2D, render,
      one D2H);
   b. the main path's detector behind a FleetBackend over make_mesh() (one
      card, data 1) and over two shards on two streams of the card, at 16
      and 32 detect planes of 300x300: the packed output bit-identical to
      TorchDetectorBackend's (each shard's to it on the shard's frames
      alone), one fixed_point_suppress and 12 fused_inverted_residual
      launches a shard a step, each of them held against its plain version
      on its own inputs (kernel 1 bit for bit, kernel 2 within phase 1's
      tolerances) at the fleet's shapes, and the step's wall time beside
      TorchDetectorBackend's;
   c. TorchApplication with WATSOR_FLEET=1 and WATSOR_FUSED_BLOCKS=1 on 16
      synthetic cameras, device render on by default: one
      ``detector-fleet`` serves, viewers on every camera's MJPEG stream
      make its DeviceRenderer draw at least one batch, with no failure;

6. training: ssd_mobilenet_v2 at 300x300 (90 classes, bf16 activations,
   f32 parameters, AdamW) takes 20 steps on one batch of 16 images painted
   and labelled by testing/prepare.py, each loss finite and the last under
   0.9 times the first, with each step's wall and CUDA-event time, images/s
   and peak memory; then one step (TF32 off, SGD at learning rate 1, 4
   images) on the card against the same step on the CPU: in f32 the loss
   within 1e-4 relative and the new BatchNorm statistics within 1e-4 of
   each leaf's largest magnitude (the update's errors printed: f32
   gradients are ill-conditioned here), in f64 also the statistics within
   1e-4 relative and the update within 1e-3 of each leaf's largest
   magnitude; and the anchor matching's duplicate claims on the card;
   efficientdet_lite0 at 320x320 takes 10 steps the same way; last the
   shape model trains on the card (150 steps at batch 16, precise
   BN), is saved as ``.msgpack``, read back by the zoo's ``load_weights``
   into ``build_detector(make_shape_config())`` and finds a black square
   under ``fused_exact``, its fixed_point_suppress launches held bit for
   bit against the plain version;
7. the (data, model) mesh on the one card:
   a. the sharded train step of ssd_mobilenet_v2 at full width (bf16,
      AdamW, a global batch of 16 painted images, 10 steps) over two
      devices of the card (data 2) and four at model_parallel=2 (2 x 2,
      the head kernels split): the loss under 0.9 of the first, each
      mesh's step wall median and images/s;
   b. one f64 step of the 2 x 2 mesh (TF32 off, SGD at learning rate 1,
      4 images) against the unsharded step on the card: the loss within
      1e-12 relative, the new statistics within 1e-10 and the gradient
      within 1e-9 of each leaf's largest magnitude, replicas equal bit for
      bit;
   c. the main path's detector behind FleetDetector at (data 2, model 2)
      on 16 detect planes: kernel 1 once and kernel 2 12 times a data
      shard a step, each launch held against its plain version, the
      packed output against the data-only fleet's under match_records'
      rules, and the f32 raw head outputs (TF32 off) within 5e-4;
   d. ``python -m watsor_tpu_torch.warmup -m ssd_mobilenet_v2 -b 1 8``
      twice into a new kernel build directory: built, then found;
8. the converters and the timing modules:
   a. the main path's seeded ssd_mobilenet_v2 tree (90 classes, full
      width) named as the public ssd_mobilenet_v2_coco_2018_03_29
      checkpoint names it, converted by the port's converter with no
      TensorFlow, saved as ``.msgpack`` and read back by the zoo into the
      main-path detector: the tree and the detections on 8 frames of
      1920x1080 bit-identical to the seeded detector's, kernels 1 and 2
      launched (1 and 12 a step);
   b. ``timing.measure_production_device_path`` at batch 32 of 1920x1080
      (detect, filters, pack and overlay in one captured CUDA graph,
      kernel 1 in it) beside the eager backend step wall; the chained
      harness on the main path's detect step at batch 8 within 10% of
      profile_step's graph time; that step's roofline row;

9. the seeded goldens (testing/golden.py): each of the nine families on
   the photographs of tests/data/images, its weights the seeded tree
   rebuilt from numpy alone and read back from ``.msgpack``, built once a
   leg and NMS mode (``fused``, ``fused_exact``): in f32 with TF32 off
   against tests/data/goldens_seeded/<family>.<mode>.json at the port's f32
   bar (1e-5), in the zoo's production bf16 at labels and places, and in
   f32 with TF32 on, which with the bf16 leg must miss records at the f32
   bar; kernel 1 once a step on each ``fused_exact`` leg, every launch held
   bit for bit against its plain version;
10. the port's measurement entry points (watsor_tpu_torch/bench.py),
   one JSON line a leg: ``step`` at batch 32 (10 steps, 3 repetitions;
   the chained cross-check, the production device path at 1080p with its
   kernel-1 launches, the roofline row) and ``app`` on 32 synthetic 1080p
   cameras with 20 s of samples on each of three paths (the default
   ``fused_exact``; ``WATSOR_FUSED_BLOCKS=1``; ``int8_full`` with
   ``pallas`` pointwise and ``nms: exact``); each leg's kernel launches
   counted from 0, and its last launches of each kernel held against the
   plain versions (kernels 1, 3 and 4 bit for bit, kernel 2 within phase
   1's tolerances);
11. the measurement legs of watsor_tpu_torch/measure/ (``bench host``,
   ``nms``, ``int8``, ``overlap``, ``models``, ``overlay``, ``restart``),
   one JSON line a leg, at fewer steps: the host stages alone (the
   detector's scatter among them); the detect step under each NMS mode at
   C = 90 and C = 2, batch 32, dispatch loop and chained, with kernel 1
   (``fused_exact``) and kernel 3 (``exact``) launched at both class
   counts; bf16 against ``int8_full`` in each pointwise mode (kernel 4
   under ``pallas``), each mode's scores within cosine 0.95 of the bf16
   step's; the backend's transfer against its step at batches 8 and 32;
   the roofline row and chained time of ssd_mobilenet_v2 and
   efficientdet_lite4; the overlay at 16 x 1080p; and two child processes
   over one new kernel build directory, the first building the four
   kernels and the second finding them. Each leg's kernel launches are
   counted from 0 and its last ones held against the plain versions as in
   phase 10;
12. the per-class NMS entry under its fused modes (the early fused form)
   on decoded boxes and sigmoid scores at efficientdet_lite4's scale (its
   76,725 anchors, 90 classes, 8 images): kernel 1 once a call in both
   greedy modes, each launch bit for bit against its plain version, each
   mode against the late form (classes and counts exact, floats within
   1e-6), bf16 scores through ``fused_exact``, and ``fused_exact`` equal
   to the classic ``exact`` (kernel 3) where 100 live anchors an image let
   the union cover every candidate; then ``bench lite4`` on
   efficientdet_lite4 at 640x640, batch 8, 3 dispatch steps and chains of
   2 and 16: every row finite and positive, and the backbone -> fpn ->
   heads chain over the model's own submodules equal to its forward bit
   for bit;

and last checks that no thread the phases started is still running (the
applications must have ended their HTTP request threads) and that nothing
of JAX, and nothing of the JAX package ``watsor_tpu``, was imported on
the way. The f32 comparisons run with TF32
off; the paths and the boots run under the process defaults, as users
run them. It uses one
card, the first visible one. Any failed phase makes the script exit
non-zero without the final line. Weights are random, from a fixed seed.
Output: versions, the card, build time, per-phase lines, a JSON line of
kernel results (each kernel's launches are those of its path's run in
phase 2; ``launches_by_run`` gives them beside those of each leg of phases
10 to 12), and as the last line ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import contextlib
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
# the port's f32 bar against the JAX package (ROADMAP.md "Slice by slice")
F32_REL_TOL = 5e-4
# the int8 walk against the f32 plain model: the bar of
# tests/test_ssd_int8.py (cosine of the raw outputs)
INT8_MIN_COSINE = 0.95
# kernel-4 launches in one int8 forward: its 38 pointwise units
INT8_CALLS = 38
# kernel-2 launches in one forward of the fused walk: its 12 blocks
FUSED_CALLS = 12
# synthetic cameras of the fleet application (phase 5c)
FLEET_CAMERAS = 16
# phase 6: train steps on one batch, and the share of the first loss the
# last must fall under (tests/test_train.py's bar)
TRAIN_STEPS = {'ssd_mobilenet_v2': 20, 'efficientdet_lite0': 10}
TRAIN_FALL = 0.9
# a train step on the card against the CPU's (TF32 off): the loss and
# the new BatchNorm statistics relative, the update (SGD at learning rate
# 1: the gradient) against each leaf's largest magnitude (phase6a)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_STATS_RTOL = 1e-4
# the shape model's training run (tests/test_shape_model.py)
SHAPE_STEPS = 150
SHAPE_BATCH = 16
# phase 7a: the sharded step's steps on one batch, and its meshes on the
# one card: (label, devices, model size)
SHARDED_STEPS = 10
SHARDED_MESHES = (('data 2', 2, 1), ('2 x 2', 4, 2))
# phase 7b: one f64 step of the 2 x 2 mesh against the unsharded step: the
# loss relative, the new BatchNorm statistics and the gradient (SGD at
# learning rate 1) against each leaf's largest magnitude
SHARDED_LOSS_RTOL = 1e-12
SHARDED_STATS_TOL = 1e-10
SHARDED_GRAD_TOL = 1e-9
# phase 7c: detect planes of the model-axis fleet
MODEL_AXIS_PLANES = 16
# phase 8b: the production path's batch (and cameras), and how far the
# chained harness's step time may lie from profile_step's graph time
PRODUCTION_BATCH = 32
CHAINED_GRAPH_RTOL = 0.10
# phase 10: bench.py's step (batch 32) at fewer steps, and the application
# at the north-star load for a shorter window, on each path (knobs, nms,
# the kernels it launches)
BENCH_STEP_ENV = {'BENCH_STEPS': '10', 'BENCH_REPS': '3'}
BENCH_APP_CAMERAS = 32
BENCH_APP_DURATION = 20
BENCH_APP_PATHS = (
    ('fused_exact', {}, None, ('fixed_point_suppress',)),
    ('fused blocks', {'WATSOR_FUSED_BLOCKS': '1'}, None,
     ('fixed_point_suppress', 'fused_inverted_residual')),
    ('int8', {'WATSOR_QUANTIZE': 'int8_full',
              'WATSOR_INT8_POINTWISE': 'pallas'}, 'exact',
     ('pallas_suppress', 'int8_matmul_requant')))
# phase 11: the measurement legs at fewer steps and shorter chains (the
# dispatch loop's steps; the chained harness's two loop lengths)
MEASURE_STEP_ENV = {'BENCH_BATCH': '32', 'BENCH_STEPS': '5', 'N_SHORT': '2',
                    'N_LONG': '8'}
MEASURE_OVERLAP_BATCHES = (8, 32)
MEASURE_MODELS = ('ssd_mobilenet_v2', 'efficientdet_lite4')
MEASURE_OVERLAY = (16, 1080, 1920)
# the kernel launches of bench nms by (kernel, shape): kernel 1 under
# fused_exact and kernel 3 under exact, at C = 90 and C = 2
MEASURE_NMS_SHAPES = {
    'fixed_point_suppress': ((32, 90, 128), (32, 2, 128)),
    'pallas_suppress': ((32, 90, 100, 4), (32, 2, 100, 4))}
# phase 12: bench lite4 on efficientdet_lite4 at its 640x640 with fewer
# steps and shorter chains (its chains long enough that the smallest part,
# the resize and normalize, stands clear of the host's jitter); the early
# fused NMS at Lite4's scale, with this many live anchors an image where
# the union must cover every candidate; its bar against the late form
# (tests/test_nms_fused.py:79)
LITE4_ENV = {'BENCH_BATCH': str(BATCH), 'BENCH_STEPS': '3', 'N_SHORT': '2',
             'N_LONG': '16'}
LITE4_LIVE_ANCHORS = 100
EARLY_LATE_ATOL = 1e-6
# the knobs earlier phases left set, cleared for every bench leg
BENCH_CLEARED = (
    'WATSOR_FLEET', 'WATSOR_FUSED_BLOCKS', 'WATSOR_QUANTIZE',
    'WATSOR_INT8_POINTWISE', 'WATSOR_DEVICE_RENDER', 'WATSOR_MIN_BUCKET',
    'WATSOR_DEVICE_POOL', 'WATSOR_MODEL', 'TRT_FLOAT_PRECISION',
    'BENCH_BATCH', 'BENCH_STEPS', 'BASELINE5_CAP', 'BASELINE5_OUT',
    'N_SHORT', 'N_LONG', 'WATSOR_FUSED_HEADS',
    'HOST_BUDGET_OUT', 'NMS_OUT', 'INT8_FULL_OUT', 'OVERLAP_RESULTS',
    'ROOFLINE_OUT', 'VALIDATE_OUT', 'WARM_RESTART_OUT', 'PROFILE_OUT')


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def tf32(enabled):
    """cuDNN's and cuBLAS's TF32 switches set to ``enabled`` for a block,
    then restored. The f32 comparisons need full f32 (cuDNN runs f32
    convolutions in TF32 by default); the paths and the application boots
    run under the process defaults, as users run them."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


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
    from watsor_tpu_torch.workload import (FUSED_SHAPES, WATCHED, Bound,
                                           cudnn_block, fixed_point_work)

    rng = np.random.default_rng(0)
    M = 128
    entry = {'name': 'fixed_point_suppress', 'route': 'cuda',
             'source': 'watsor_tpu_torch/csrc/nms_fixed_point.cu',
             'replaces': 'watsor_tpu/ops/nms_pallas.py:158',
             'max_abs_err': 0.0, 'library_ms': None}
    # the main path's union (C = 2), all 90 classes, and a ragged union
    for C, m in ((2, M), (90, M), (2, 100)):
        # scores on a 1/64 grid: many exact ties across candidates
        s = np.floor(rng.uniform(0, 1, (BATCH, C, m)) * 64) / 64
        yx = rng.uniform(0, 1, (BATCH, m, 2))
        hw = rng.uniform(0.02, 0.4, (BATCH, m, 2))
        boxes = torch.tensor(np.concatenate([yx, yx + hw], -1),
                             dtype=torch.float32, device=device)
        scores = torch.tensor(s, dtype=torch.float32, device=device)
        got = nms_fixed_point.fixed_point_suppress(scores, boxes, 0.6)
        want = nms_fixed_point.fixed_point_suppress_plain(scores, boxes, 0.6)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                'fixed_point_suppress C={} M={}: {} of {} keep bits differ'
                .format(C, m, int((got != want).sum()), got.numel()))
        ms = time_ms(lambda: nms_fixed_point.fixed_point_suppress(
            scores, boxes, 0.6))
        plain_ms = time_ms(lambda: nms_fixed_point.fixed_point_suppress_plain(
            scores, boxes, 0.6), reps=5, inner=2)
        nbytes, ops = fixed_point_work(BATCH, C, m)
        bound = Bound().add(nbytes, f32=ops)
        log('phase1 fixed_point_suppress B={} C={} M={}: bit-identical, '
            'kept {}, kernel {:.4f} ms, plain {:.4f} ms, bound {:.6f} ms'
            .format(BATCH, C, m, int(got.sum()), ms, plain_ms, bound.ms))
        if (C, m) == (len(WATCHED), M):       # the main path's shape
            entry.update(ms=ms, plain_ms=plain_ms)
            bound.update(entry)
    results.append(entry)

    entry = {'name': 'fused_inverted_residual', 'route': 'cuda',
             'source': 'watsor_tpu_torch/csrc/fused_block.cu',
             'replaces': 'watsor_tpu/ops/fused_block.py:32',
             'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0,
             'library_ms': 0.0}
    roof = Bound()
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
        library_ms = time_ms(cudnn_block(x, *args, residual))
        # x in and out once, bf16 weights, f32 biases; the 1x1 products on
        # the bf16 tensor cores, the depthwise in f32 on the CUDA cores
        pixels = BATCH * H * H
        work = (2 * pixels * (C_in + C_out) + 2 * E * (C_in + 9 + C_out) +
                4 * (2 * E + C_out),
                {'bf16': 2 * pixels * E * (C_in + C_out),
                 'f32': 2 * 9 * pixels * E})
        one = Bound().add(work[0], **work[1])
        roof.add(work[0], **work[1])
        plan = fused_block.plan_launch(BATCH, H, H, C_in, E, C_out)
        log('phase1 fused_inverted_residual B={} {}x{} {}->{}->{}{}: '
            'max err {:.3g}, kernel {:.4f} ms, plain {:.4f} ms, cuDNN '
            '{:.4f} ms, bound {:.4f} ms; plan rows {} cluster {} blocks '
            '{} smem {}'.format(
                BATCH, H, H, C_in, E, C_out, ' +res' if residual else '',
                err, ms, plain_ms, library_ms,
                one.ms, plan.rows, plan.cluster,
                plan.blocks, plan.smem))
        entry['max_abs_err'] = max(entry['max_abs_err'], err)
        entry['ms'] += ms                # one forward's 12 blocks
        entry['plain_ms'] += plain_ms
        entry['library_ms'] += library_ms
    roof.update(entry)
    results.append(entry)
    phase_kernels_int8_path(device, results, rng)


def phase_kernels_int8_path(device, results, rng):
    """The int8 path's two kernels against their plain versions."""
    import collections
    import torch
    from watsor_tpu_torch.ops import int8_matmul, nms_suppress
    from watsor_tpu_torch.workload import (WATCHED, Bound, int8_call_work,
                                           int8_pointwise_calls,
                                           int_mm_operand, suppress_work)

    K = 100                              # per_class_k
    entry = {'name': 'pallas_suppress', 'route': 'cuda',
             'source': 'watsor_tpu_torch/csrc/nms_suppress.cu',
             'replaces': 'watsor_tpu/ops/nms_pallas.py:98',
             'max_abs_err': 0.0, 'library_ms': None}
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
        nbytes, ops = suppress_work(BATCH, C, K)
        bound = Bound().add(nbytes, f32=ops)
        log('phase1 pallas_suppress B={} C={} K={}: bit-identical, kept {}, '
            'kernel {:.4f} ms, plain {:.4f} ms, bound {:.6f} ms'.format(
                BATCH, C, K, int((got > 0).sum()), ms, plain_ms, bound.ms))
        if C == len(WATCHED):            # the int8 path's shape
            entry.update(ms=ms, plain_ms=plain_ms)
            bound.update(entry)
    results.append(entry)

    # library_ms: torch._int_mm, the int8 product to int32 alone (GEMM
    # only, no epilogue), summed over the forward's calls
    entry = {'name': 'int8_matmul_requant', 'route': 'cuda',
             'source': 'watsor_tpu_torch/csrc/int8_matmul.cu',
             'replaces': 'watsor_tpu/ops/int8_matmul.py:111',
             'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0,
             'library_ms': 0.0}
    roof = Bound()
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
        w_mm = int_mm_operand(x, w)[0]
        library_ms = time_ms(lambda: torch._int_mm(x, w_mm))
        nbytes, ops = int8_call_work(M, K, N, quantize)
        plan = int8_matmul.plan_launch(M, K, N)
        log('phase1 int8_matmul_requant M={} K={} N={} {}{} x{}: '
            'bit-identical, kernel {:.4f} ms, plain {:.4f} ms, _int_mm '
            '{:.4f} ms, bound {:.4f} ms; plan bm {} bn {} splits {} stages '
            '{} tiles {} blocks {} smem {}'.format(
                M, K, N, 'int8' if quantize else 'f32',
                ' relu6' if relu6 else '', n, ms, plain_ms, library_ms,
                Bound().add(nbytes, int8=ops).ms, plan.bm, plan.bn,
                plan.splits, int8_matmul.STAGES, plan.tiles, plan.blocks,
                plan.smem))
        entry['max_abs_err'] = max(entry['max_abs_err'], err)
        entry['ms'] += n * ms            # one forward's 38 calls
        entry['plain_ms'] += n * plain_ms
        entry['library_ms'] += n * library_ms
        for _ in range(n):
            roof.add(nbytes, int8=ops)
    if sum(calls.values()) != INT8_CALLS:
        raise AssertionError('{} pointwise calls a forward'.format(
            sum(calls.values())))
    roof.update(entry)
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
    from watsor_tpu_torch.runtime.channel import balanced_queue_group
    from watsor_tpu_torch.runtime.frames import FrameBuffer, State
    from watsor_tpu_torch.runtime.tasks import Payload
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
        with tf32(False):
            wb, wl = reference.raw_apply(x)
        with tf32(True):
            tb, tl = reference.raw_apply(x)
        out = detector.detect_batch(images)
    torch.cuda.synchronize()
    gaps = [float((t - w).abs().max() / w.abs().max())
            for t, w in ((tb, wb), (tl, wl))]
    log('phase2 TF32: f32 plain model raw outputs with TF32 on against off, '
        'relative max error boxes {:.3g} logits {:.3g} (the f32 bar {})'
        .format(gaps[0], gaps[1], F32_REL_TOL))
    errs = []
    for got, want in ((gb, wb), (gl, wl)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError('non-finite raw outputs')
        errs.append(float((got - want).abs().max() / want.abs().max()))
    if max(errs) > MODEL_REL_TOL:
        raise AssertionError('fused bf16 vs f32 plain: relative errors {}'
                             .format(errs))
    _check_detections(out, 2, detector.config.max_detections)
    log('phase2 reference: fused bf16 vs plain f32 raw outputs, relative '
        'max error boxes {:.3g} logits {:.3g} (bound {})'.format(
            errs[0], errs[1], MODEL_REL_TOL))


def _check_detections(out, batch, n):
    """Detections of the expected shape, finite, scores in [0, 1]."""
    import torch
    if tuple(out.boxes.shape) != (batch, n, 4) or \
            not bool(torch.isfinite(out.boxes).all()) or \
            not bool(((out.scores >= 0) & (out.scores <= 1)).all()) or \
            not bool(((out.valid >= 0) & (out.valid <= n)).all()):
        raise AssertionError('malformed detect_batch output')


def _path_step(detector, frames, wrapper):
    """One detect step with ``wrapper``'s count set to 0 just before and
    read just after, and ops/nms.py's calls of it recorded (the wrapper
    still runs); returns (launches, recorded calls)."""
    import torch
    from watsor_tpu_torch.profile_step import _suppression
    calls = []

    def record(*args):
        calls.append(args)
        return wrapper(*args)

    with _suppression(record, wrapper.__name__):
        wrapper.launches = 0
        out = detector.detect_batch(frames)
        torch.cuda.synchronize()
        launches = wrapper.launches
    _check_detections(out, frames.shape[0], detector.config.max_detections)
    return launches, calls


def _f32_gap(detector, frames):
    """The bf16 detector's raw outputs against its f32 plain model on the
    same resized and normalized batch, TF32 off: relative max errors
    (boxes, logits)."""
    import torch
    from watsor_tpu_torch.models.efficientdet import (EfficientDetConfig,
                                                      build_effdet)
    from watsor_tpu_torch.models.ssd import build_detector
    from watsor_tpu_torch.ops.preprocess import resize_bilinear
    cfg = detector.config
    effdet = isinstance(cfg, EfficientDetConfig)
    build = build_effdet if effdet else build_detector
    reference = build(cfg._replace(dtype=torch.float32),
                      variables=detector.variables, anchors=detector.anchors,
                      device=frames.device)
    x = resize_bilinear(frames, cfg.input_size, cfg.input_size)
    x = (x - cfg.mean_rgb) / cfg.stddev_rgb if effdet else \
        x * (2.0 / 255.0) - 1.0
    with torch.inference_mode():
        got = detector.raw_apply(x)
        with tf32(False):
            want = reference.raw_apply(x)
    errs = []
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError('non-finite raw outputs')
        errs.append(float((g - w).abs().max() / w.abs().max()))
    return errs


def phase_families(device):
    """phase4: each other family at full width, its detect step on the
    card through kernel 1, held against the plain kernel and the f32
    model."""
    import torch
    from watsor_tpu_torch.ops import nms_fixed_point
    from watsor_tpu_torch.profile_step import graph_ms
    from watsor_tpu_torch.workload import (FAMILIES, build_family_detector,
                                           frames_1080p)

    fp = nms_fixed_point.fixed_point_suppress
    frames = frames_1080p(device)
    for name in FAMILIES:
        start = time.perf_counter()
        detector = build_family_detector(device, name)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - start
        launches, calls = _path_step(detector, frames, fp)
        if launches != 1 or len(calls) != 1:
            raise AssertionError('{}: {} fixed_point_suppress launches in '
                                 'one step, 1 expected'.format(name,
                                                               launches))
        scores, boxes, thr = calls[0]
        got = fp(scores, boxes, thr)
        want = nms_fixed_point.fixed_point_suppress_plain(scores, boxes, thr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError('{}: fixed_point_suppress {} of {} keep '
                                 'bits differ from the plain version'.format(
                                     name, int((got != want).sum()),
                                     got.numel()))
        step_ms = graph_ms(lambda: detector.detect_batch(frames))
        errs = _f32_gap(detector, frames)
        if max(errs) > MODEL_REL_TOL:
            raise AssertionError('{}: bf16 vs f32 plain relative errors {}'
                                 .format(name, errs))
        log('phase4 families {}: {}x{}, {} anchors, build {:.2f} s, detect '
            'step {:.4f} ms on the device (CUDA-graph replay, batch {} of '
            '1920x1080), fixed_point_suppress launches {} a step at {}, '
            'bit-identical (kept {}), bf16 vs f32 plain raw outputs '
            'relative max error boxes {:.3g} logits {:.3g} (bar {})'.format(
                name, detector.config.input_size, detector.config.input_size,
                len(detector.anchors), build_s, step_ms, BATCH, launches,
                list(scores.shape), int(got.sum()), errs[0], errs[1],
                MODEL_REL_TOL))
        del detector, calls, scores, boxes, got, want
        torch.cuda.empty_cache()


def phase_families_exact(device):
    """phase4: efficientdet_lite0 under ``nms: exact``, its one
    pallas_suppress launch a step held against the plain version."""
    import torch
    from watsor_tpu_torch.ops import nms_suppress
    from watsor_tpu_torch.workload import build_family_detector, frames_1080p

    ps = nms_suppress.pallas_suppress
    frames = frames_1080p(device)
    detector = build_family_detector(device, 'efficientdet_lite0',
                                     nms_mode='exact')
    launches, calls = _path_step(detector, frames, ps)
    if launches != 1 or len(calls) != 1:
        raise AssertionError('{} pallas_suppress launches in one step, 1 '
                             'expected'.format(launches))
    boxes, scores, thr = calls[0]
    got = ps(boxes, scores, thr)
    want = nms_suppress.pallas_suppress_plain(boxes, scores, thr)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError('pallas_suppress: {} of {} scores differ from '
                             'the plain version'.format(
                                 int((got != want).sum()), got.numel()))
    log('phase4 families efficientdet_lite0 nms exact: pallas_suppress '
        'launches {} a step at {}, bit-identical (kept {})'.format(
            launches, list(scores.shape), int((got > 0).sum())))


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
        with tf32(False):
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
    _check_detections(out, 2, detector.config.max_detections)
    log('int8 reference: int8 walk vs plain f32 raw outputs, cosine boxes '
        '{:.5f} logits {:.5f} (bound {})'.format(cosines[0], cosines[1],
                                                 INT8_MIN_COSINE))


def _free_port():
    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _synthetic_cameras(text, n):
    """config/config.yaml's text with its cameras replaced by ``n``
    synthetic://loop cameras, and without its video encoder."""
    import yaml
    config = yaml.safe_load(text)
    config['ffmpeg'].pop('encoder', None)
    config['cameras'] = [{'cam{}'.format(i): {
        'width': 1280, 'height': 720,
        'input': 'synthetic://loop?seed={}'.format(i),
        'detect': [{'person': {'area': 1, 'confidence': 10}},
                   {'car': {'area': 1, 'confidence': 10}}]}}
        for i in range(n)]
    return yaml.safe_dump(config)


def phase_app(label, env, nms=None, model=None, cameras=None,
              deadline_s=600, inspect=None):
    """TorchApplication on config/config.yaml, with the environment knobs
    ``env`` (None removes one), ``nms`` set in the copied config, ``model``
    as ``--model`` and, with ``cameras``, that many synthetic cameras in
    place of the demo camera, until detections flow; then, with
    ``inspect``, ``inspect(app, url)`` while the application runs."""
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
        if cameras:
            text = _synthetic_cameras(text, cameras)
        with open(path, 'w') as f:
            f.write(text)
        argv = ['-c', path, '-m', os.path.join(workdir, 'no_weights')]
        args = _parse_commandline_arguments(
            argv + (['--model', model] if model else []))
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
                if not thread.is_alive():
                    raise AssertionError('the application stopped')
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
            if inspect is not None:
                inspect(app, url)
        finally:
            app._stop_main.set()
            thread.join(60)
        if health != 'UP':
            raise AssertionError('/health answered {!r}'.format(health))
        log('{}: /health {}, detectors {}'.format(
            label, health, json.dumps(metrics['detectors'])))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_overlay(device):
    """phase5a: render_boxes at [16, 1080, 1920, 3] with 100 box slots a
    frame, bit-identical to its CPU result with TF32 on and off, timed in
    both modes against its bound; then one DeviceRenderer batch of 16
    frames, H2D, render and D2H."""
    import torch
    from watsor_tpu_torch.ops.overlay import (coco_color_table, pixel_index,
                                              render_boxes)
    from watsor_tpu_torch.output.device_render import DeviceRenderer
    from watsor_tpu_torch.workload import (OVERLAY_BATCH, Bound,
                                           overlay_inputs, overlay_work)

    frames, boxes, classes = overlay_inputs()
    B, H, W, _ = frames.shape
    cpu = [torch.from_numpy(a) for a in (frames, boxes, classes)]
    start = time.perf_counter()
    want = render_boxes(*cpu, coco_color_table('cpu'))
    cpu_s = time.perf_counter() - start
    dev = [t.to(device) for t in cpu]
    table = coco_color_table(device)
    index = pixel_index(H, W, device)
    nbytes, ops = overlay_work(B, H, W, boxes.shape[1])
    drawn = int((want.numpy() != frames).any(-1).sum())
    line = []
    for mode in (False, True):
        with tf32(mode):
            got = render_boxes(*dev, table, index=index)
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want):
                raise AssertionError(
                    'render_boxes TF32 {}: {} of {} bytes differ from the CPU'
                    .format('on' if mode else 'off',
                            int((got.cpu() != want).sum()), want.numel()))
            ms = time_ms(lambda: render_boxes(*dev, table, index=index),
                         reps=5, inner=5)
        ops_ms = Bound().add(0, **{'tf32' if mode else 'f32': ops}).ms
        line.append('TF32 {} {:.4f} ms (operation bound {:.4f} ms)'.format(
            'on' if mode else 'off', ms, ops_ms))
    log('phase5a overlay render_boxes [{}, {}, {}, 3], {} slots, {} valid '
        'a frame, thickness 2: bit-identical to the CPU with TF32 off and '
        'on ({} pixels drawn); {}; byte bound {:.4f} ms ({:.1f} MB in and '
        'out); the CPU reference {:.2f} s'.format(
            B, H, W, boxes.shape[1], int((classes > 0).sum(-1).max()), drawn,
            ', '.join(line), Bound().add(nbytes).ms, nbytes / 1e6, cpu_s))

    # the round trip: 16 cameras submit at once, one batch renders
    renderer = DeviceRenderer(window_ms=50.0, max_batch=OVERLAY_BATCH,
                              device=device)
    walls = []
    try:
        for rnd in range(6):
            results = [None] * B
            barrier = threading.Barrier(B + 1)

            def submit(i):
                barrier.wait(30)
                results[i] = renderer.render(frames[i], boxes[i],
                                             classes[i], timeout=60)

            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(B)]
            for thread in threads:
                thread.start()
            barrier.wait(30)
            t0 = time.perf_counter()
            for thread in threads:
                thread.join(60)
            walls.append(1e3 * (time.perf_counter() - t0))
            if rnd == 0:
                for i in range(B):
                    if not np.array_equal(results[i], want[i].numpy()):
                        raise AssertionError('DeviceRenderer frame {} differs '
                                             'from the CPU render'.format(i))
    finally:
        renderer.close()
    if renderer.failures or renderer.timeouts or \
            renderer.frames != 6 * B:
        raise AssertionError('DeviceRenderer: {} failures, {} timeouts, {} '
                             'frames'.format(renderer.failures,
                                             renderer.timeouts,
                                             renderer.frames))
    log('phase5a DeviceRenderer: {} frames of {}x{} in {} batches (mean '
        '{:.1f} a batch), equal to the CPU render; a round of {} concurrent requests '
        '(gather, H2D, render, one D2H) median {:.3f} ms, first {:.3f} ms'
        .format(renderer.frames, W, H, renderer.batches,
                renderer.frames / renderer.batches, B,
                statistics.median(walls[1:]), walls[0]))


@contextlib.contextmanager
def _recorded_kernels(calls, keep=None):
    """The path's calls of the four kernels (as ops/nms.py,
    models/ssd_fused.py and models/ssd_int8.py make them) recorded into
    ``calls`` with a copy of each output: (name, args, kwargs, output). The
    kernels still run. With ``keep``, each kernel's last ``keep`` launches
    only (a long run's inputs would fill the card)."""
    import collections
    from watsor_tpu_torch.models import ssd_fused, ssd_int8
    from watsor_tpu_torch.ops import nms
    recent = collections.defaultdict(
        lambda: collections.deque(maxlen=keep))

    def recorder(wrapper):
        def record(*args, **kwargs):
            out = wrapper(*args, **kwargs)
            entry = (wrapper.__name__, args, kwargs, out.clone())
            if keep is None:
                calls.append(entry)
            else:
                recent[wrapper.__name__].append(entry)
            return out
        return record

    saved = [(module, name, getattr(module, name)) for module, name in (
        (nms, 'fixed_point_suppress'),
        (ssd_fused, 'fused_inverted_residual'),
        (nms, 'pallas_suppress'),
        (ssd_int8, 'int8_matmul_requant'))]
    for module, name, wrapper in saved:
        setattr(module, name, recorder(wrapper))
    try:
        yield
    finally:
        for module, name, wrapper in saved:
            setattr(module, name, wrapper)
        for entries in recent.values():
            calls.extend(entries)


def _hold_against_plain(calls):
    """Each recorded launch against its plain version on its own inputs:
    kernels 1, 3 and 4 bit for bit, kernel 2 within phase 1's tolerances.
    Returns the shapes held, by kernel."""
    import torch
    from watsor_tpu_torch.ops import (fused_block, int8_matmul,
                                      nms_fixed_point, nms_suppress)
    plain = {'fixed_point_suppress':
             nms_fixed_point.fixed_point_suppress_plain,
             'fused_inverted_residual':
             fused_block.fused_inverted_residual_plain,
             'pallas_suppress': nms_suppress.pallas_suppress_plain,
             'int8_matmul_requant': int8_matmul.int8_matmul_requant_plain}
    shapes = {name: [] for name in plain}
    torch.cuda.synchronize()
    for name, args, kwargs, got in calls:
        want = plain[name](*args, **kwargs)
        torch.cuda.synchronize()
        shape = tuple(args[0].shape)
        shapes[name].append(shape)
        if name != 'fused_inverted_residual':
            if not torch.equal(got, want):
                raise AssertionError(
                    '{} {}: {} of {} outputs differ from the plain version'
                    .format(name, shape, int((got != want).sum()),
                            got.numel()))
            continue
        diff = (got.float() - want.float()).abs()
        if bool((diff > FUSED_ATOL + FUSED_RTOL * want.float().abs()).any()) \
                or float(diff.mean()) > FUSED_MEAN_ATOL:
            raise AssertionError('fused_inverted_residual {}: max err {} mean '
                                 '{}'.format(shape, float(diff.max()),
                                             float(diff.mean())))
    return shapes


def phase_fleet(device):
    """phase5b: the main path's detector behind a FleetBackend over one
    card (data 1) and over two shards on two streams of it, at 16 and 32
    detect planes: bit-identical to TorchDetectorBackend (each shard to it
    on the shard's frames alone), the kernels launched once a shard a step
    (kernel 1) and 12 times a shard a forward (kernel 2), each of those
    launches held against its plain version on its own inputs, and the
    step's wall time beside the single backend's."""
    from watsor_tpu_torch.detection import FleetBackend, TorchDetectorBackend
    from watsor_tpu_torch.ops import fused_block, nms_fixed_point
    from watsor_tpu_torch.parallel import FleetDetector, make_mesh
    from watsor_tpu_torch.workload import (FLEET_BATCHES,
                                           build_main_path_detector,
                                           camera_filters, detect_planes,
                                           fleet_against_single)

    counters = (nms_fixed_point.fixed_point_suppress,
                fused_block.fused_inverted_residual)
    detector = build_main_path_detector(device)
    cams = ['cam{}'.format(i) for i in range(max(FLEET_BATCHES))]
    tables, refiners = camera_filters(cams)
    planes = detect_planes(max(FLEET_BATCHES), seed=4)
    single = TorchDetectorBackend(detector, device, camera_tables=tables,
                                  zone_refiners=refiners)
    meshes = (('data 1', make_mesh()),
              ('2 shards', make_mesh(devices=[device, device])))
    for label, mesh in meshes:
        backend = FleetBackend(FleetDetector(mesh, detector),
                               camera_tables=tables, zone_refiners=refiners)
        n_shards = mesh.shape['data']
        for batch in FLEET_BATCHES:
            calls = []
            row = fleet_against_single(
                backend, single, planes[:batch], cams[:batch], counters,
                reps=15, around=lambda: _recorded_kernels(calls))
            launches = row['launches']
            if launches['fixed_point_suppress'] != n_shards or \
                    launches['fused_inverted_residual'] != \
                    FUSED_CALLS * n_shards:
                raise AssertionError('fleet {} batch {}: launches {}'.format(
                    label, batch, launches))
            if not all(row['equal']):
                raise AssertionError(
                    'fleet {} batch {}: shards equal to TorchDetectorBackend '
                    '{}'.format(label, batch, row['equal']))
            shapes = _hold_against_plain(calls)
            fp_shapes = sorted(set(shapes['fixed_point_suppress']))
            log('phase5b fleet {} ({}) batch {}: {} shard(s) of {}, packed '
                'output bit-identical to TorchDetectorBackend{}, {} '
                'detections kept, launches {} (this step alone); '
                'fixed_point_suppress at {} bit-identical to its plain '
                'version and the {} fused_inverted_residual launches within '
                'tolerance; step wall median {:.3f} / {:.3f} ms, '
                'TorchDetectorBackend {:.3f} / {:.3f} ms'.format(
                    label, backend.device_name, batch, n_shards, row['shard'],
                    ' on each shard\'s frames' if n_shards > 1 else '',
                    row['kept'], launches, fp_shapes,
                    len(shapes['fused_inverted_residual']),
                    *row['fleet_wall_ms'], *row['single_wall_ms']))


def _watch(url, camera, frames, stop):
    """Read ``frames`` frames of a camera's MJPEG stream (the visual effects
    run only while someone watches)."""
    with urllib.request.urlopen('{}/video/mjpeg/{}'.format(url, camera),
                                timeout=30) as stream:
        seen = 0
        while seen < frames and not stop.is_set():
            chunk = stream.read(65536)
            if not chunk:
                return
            seen += chunk.count(b'--frame')


def fleet_app_check(app, url, n_cameras, watch_s=20.0):
    """phase5c: the fleet's one detector serves; viewers on every camera
    make the shared DeviceRenderer draw, with no failure."""
    names = [d.name for d in app._detectors]
    if names != ['detector-fleet']:
        raise AssertionError('detectors {}'.format(names))
    renderer = app._device_renderer
    if renderer is None:
        raise AssertionError('no DeviceRenderer under WATSOR_FLEET=1')
    stop = threading.Event()
    errors = []

    def watch(camera):
        try:
            _watch(url, camera, 1000, stop)
        except OSError as exc:
            errors.append(exc)

    viewers = [threading.Thread(target=watch, args=('cam{}'.format(i),),
                                daemon=True) for i in range(n_cameras)]
    for viewer in viewers:
        viewer.start()
    time.sleep(watch_s)
    stop.set()
    for viewer in viewers:
        viewer.join(60)
    with urllib.request.urlopen(url + '/metrics', timeout=5) as r:
        detector = json.loads(r.read())['detectors'][0]
    log('phase5c fleet application: detector {} ({}), {} cameras, fps '
        '{}, latency p50 {} ms p95 {} ms; DeviceRenderer on {}: {} batches, '
        '{} frames, mean batch {:.2f}, {} timeouts, {} failures; {} viewer '
        'errors'.format(
            names[0], detector['name'], n_cameras, detector['fps'],
            detector['latency_ms_p50'], detector['latency_ms_p95'],
            renderer.device, renderer.batches, renderer.frames,
            renderer.frames / max(renderer.batches, 1), renderer.timeouts,
            renderer.failures, len(errors)))
    if renderer.batches < 1 or renderer.failures:
        raise AssertionError('DeviceRenderer rendered {} batches with {} '
                             'failures'.format(renderer.batches,
                                               renderer.failures))


def phase_train(device, name, label):
    """phase6a/6b: the zoo's ``name`` at full width (bf16 activations, f32
    parameters, make_optimizer()) trained TRAIN_STEPS[name] steps on one
    batch of TRAIN_BATCH images painted at its input size: every loss
    finite and the last under TRAIN_FALL times the first."""
    import torch
    from watsor_tpu_torch.workload import (TRAIN_BATCH, build_train_state,
                                           timed_train_steps, train_batch)
    start = time.perf_counter()
    config, state, step = build_train_state(device, name)
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in train_batch(config.input_size).items()}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    torch.cuda.reset_peak_memory_stats(device)
    rows = timed_train_steps(state, step, batch, TRAIN_STEPS[name])
    peak = torch.cuda.max_memory_allocated(device)
    for i, row in enumerate(rows):
        log('{} train {} step {}: loss {:.4f}, wall {:.3f} ms, CUDA-event '
            '{:.3f} ms, {:.1f} images/s'.format(
                label, name, i + 1, row['loss'], row['wall_ms'],
                row['event_ms'], TRAIN_BATCH / row['wall_ms'] * 1e3))
    losses = [row['loss'] for row in rows]
    wall = statistics.median(row['wall_ms'] for row in rows[1:])
    log('{} train {} {}x{} {} batch {}: build {:.2f} s, loss {:.4f} -> '
        '{:.4f} in {} steps, step wall median {:.3f} ms (after the first, '
        '{:.3f} ms), {:.1f} images/s, max_memory_allocated {:.3f} GB'.format(
            label, name, config.input_size, config.input_size, config.dtype,
            TRAIN_BATCH, build_s, losses[0], losses[-1], len(losses), wall,
            rows[0]['wall_ms'], TRAIN_BATCH / wall * 1e3, peak / 1e9))
    if not all(np.isfinite(losses)) or not losses[-1] < \
            TRAIN_FALL * losses[0]:
        raise AssertionError('{}: losses {} do not fall under {} of the '
                             'first'.format(name, losses, TRAIN_FALL))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flat(value, prefix + (key,))
    else:
        yield '/'.join(prefix), np.asarray(tree, np.float64)


def _check_variables():
    """ssd_mobilenet_v2's seeded weights with every BatchNorm's scale,
    bias and statistics redrawn from a numpy seed, as the CPU tests redraw
    them: under flax's constant init (bias 0) a BatchNorm whose input is a
    linear map of another's output has a batch mean of 0 in exact
    arithmetic, which each device rounds to noise of its own."""
    import torch
    from watsor_tpu_torch.models.train import _model_for
    from watsor_tpu_torch.models.weights import (export_variables,
                                                 init_weights)
    from watsor_tpu_torch.models.zoo import model_config
    model = init_weights(_model_for(model_config('ssd_mobilenet_v2')),
                         torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)

    def redraw(node, key=None):
        if isinstance(node, dict):
            return {k: redraw(v, k) for k, v in sorted(node.items())}
        if key in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
        if key in ('bias', 'mean'):
            return rng.normal(0.0, 0.1, node.shape).astype(np.float32)
        return node

    return redraw(export_variables(model))


def _train_check_step(device, dtype, batch, variables):
    """One step of ssd_mobilenet_v2 at full width in ``dtype`` on
    ``device`` (TF32 off) with SGD at learning rate 1, from ``variables``:
    (flat variables before, after, metrics, seconds)."""
    import functools
    import torch
    from watsor_tpu_torch.models.train import (_model_for, init_train_state,
                                               make_train_step)
    from watsor_tpu_torch.models.weights import export_variables
    from watsor_tpu_torch.models.zoo import model_config
    config = model_config('ssd_mobilenet_v2')._replace(dtype=dtype)
    state = init_train_state(config, variables,
                             functools.partial(torch.optim.SGD, lr=1.0),
                             model=_model_for(config).to(dtype),
                             device=device)
    before = dict(_flat(export_variables(state.model, np.float64)))
    start = time.perf_counter()
    with tf32(False):
        metrics = {k: float(v) for k, v in
                   make_train_step(config)(state, batch).items()}
    seconds = time.perf_counter() - start
    return before, dict(_flat(export_variables(state.model, np.float64))), \
        metrics, seconds


def _compare_steps(card, cpu):
    """(loss relative error; statistics: worst relative error where the
    CPU's value is not 0, the card's largest magnitude where it is, and
    the worst error against its leaf's largest magnitude, each as a share
    of it; the update: [(error against the leaf's largest magnitude, the
    leaf's largest against the tree's on the CPU, and on the card, leaf),
    ...] worst first)."""
    loss_err = abs(card[2]['loss'] - cpu[2]['loss']) / abs(cpu[2]['loss'])
    stats_rel, stats_zero, stats_leaf = 0.0, 0.0, 0.0
    for key, want in cpu[1].items():
        if key.startswith('batch_stats/'):
            got, nonzero = card[1][key], want != 0
            scale = np.abs(want).max()
            if nonzero.any():
                stats_rel = max(stats_rel, float((np.abs(
                    got - want)[nonzero] / np.abs(want[nonzero])).max()))
            if (~nonzero).any():
                stats_zero = max(stats_zero, float(
                    np.abs(got[~nonzero]).max() / scale))
            stats_leaf = max(stats_leaf,
                             float(np.abs(got - want).max() / scale))
    grads = {k: (card[0][k] - card[1][k], cpu[0][k] - cpu[1][k])
             for k in cpu[0] if k.startswith('params/')}
    tree_max = max(np.abs(w).max() for _, w in grads.values())
    grad_err = sorted(((np.abs(g - w).max() / max(np.abs(w).max(), 1e-300),
                        np.abs(w).max() / tree_max,
                        np.abs(g).max() / tree_max, k)
                       for k, (g, w) in grads.items()), reverse=True)
    return loss_err, (stats_rel, stats_zero, stats_leaf), grad_err


def phase_train_f32(device):
    """phase6a: one step of ssd_mobilenet_v2 at full width with SGD at
    learning rate 1 (the update is the gradient), TF32 off, on the card
    against the same step of the port on the CPU, from the same seeded
    weights (``_check_variables``) and 4 painted images: in f32 the loss
    within TRAIN_LOSS_RTOL and the new BatchNorm statistics within
    TRAIN_STATS_RTOL of each leaf's largest magnitude (the update is
    printed: the gradients of train-mode BatchNorm networks are
    ill-conditioned in f32, and leaves whose gradient cancels differ by
    their own size; elementwise, a mean near 0 has no relative error of
    its own); in f64 the loss, the statistics within TRAIN_STATS_RTOL
    elementwise and of each leaf's largest, and the update within
    TRAIN_GRAD_TOL of each leaf's largest magnitude, where a leaf whose
    f64 gradient is under 1e-9 of the tree's largest on the CPU (zero in
    exact arithmetic: a BatchNorm bias whose output reaches the loss only
    through train-mode BatchNorms) is held under the same 1e-9 on the
    card. Then the anchor matching's duplicate
    claims resolved on the card as on the CPU."""
    import torch
    from watsor_tpu_torch.models.train import _match_anchors
    from watsor_tpu_torch.workload import train_batch
    batch = train_batch(300, n=4)
    variables = _check_variables()
    failures = []
    for dtype, exact in ((torch.float32, False), (torch.float64, True)):
        card = _train_check_step(device, dtype, batch, variables)
        cpu = _train_check_step(torch.device('cpu'), dtype, batch, variables)
        loss_err, stats, grad_err = _compare_steps(card, cpu)
        stats_rel, stats_zero, stats_leaf = stats
        zero = [row for row in grad_err if row[1] < 1e-9]
        live = [row for row in grad_err if row[1] >= 1e-9]
        zero_card = max([card_share for _, _, card_share, _ in zero] + [0.0])
        over = sum(e > TRAIN_GRAD_TOL for e, _, _, _ in live)
        log('phase6a {} train step (TF32 off, SGD lr 1, 4 images) card '
            'against CPU: loss {:.9g} / {:.9g}, relative {:.3g} (bar {}); '
            'new BatchNorm statistics relative max {:.3g} (bar {}), where '
            "the CPU's are 0 the card's under {:.3g} of their leaf's "
            "largest, against each leaf's largest {:.3g}; update against "
            "each leaf's largest magnitude: {} of "
            '{} leaves over {} (worst {}); {} leaves under 1e-9 of the '
            "tree's largest on the CPU, the card's under {:.3g} of it; card "
            '{:.2f} s, CPU {:.2f} s'.format(
                str(dtype).split('.')[1], card[2]['loss'], cpu[2]['loss'],
                loss_err, TRAIN_LOSS_RTOL, stats_rel, TRAIN_STATS_RTOL,
                stats_zero, stats_leaf, over, len(live), TRAIN_GRAD_TOL,
                ['{} {:.3g} (leaf max {:.3g} of the tree max)'.format(k, e, m)
                 for e, m, _, k in live[:4]], len(zero), zero_card, card[3],
                cpu[3]))
        if loss_err > TRAIN_LOSS_RTOL:
            failures.append('{}: loss {:.3g}'.format(dtype, loss_err))
        if stats_leaf > TRAIN_STATS_RTOL or exact and (
                stats_rel > TRAIN_STATS_RTOL or
                stats_zero > TRAIN_STATS_RTOL):
            failures.append('{}: statistics {:.3g} / {:.3g} / {:.3g}'.format(
                dtype, stats_rel, stats_zero, stats_leaf))
        if exact and (over or zero_card >= 1e-9):
            failures.append('{}: {} leaves over {}, zero leaves {:.3g}'
                            .format(dtype, over, TRAIN_GRAD_TOL, zero_card))
    # duplicate claims: 32 ground truths whose best anchor is anchor 7, the
    # last one invalid; the highest valid index (30) wins on every device
    anchors = torch.rand(1917, 4, generator=torch.Generator().manual_seed(0))
    anchors = torch.cat([anchors[:, :2] * 0.5,
                         anchors[:, :2] * 0.5 + 0.1 + anchors[:, 2:] * 0.4],
                        dim=1)
    gt = anchors[7].repeat(32, 1) + torch.linspace(0, 1e-3, 32)[:, None]
    labels = torch.arange(1, 33, dtype=torch.int32)
    valid = torch.ones(32, dtype=torch.bool)
    valid[-1] = False
    matched = [_match_anchors(anchors.to(d), (10.0, 10.0, 5.0, 5.0),
                              gt[None].to(d), labels[None].to(d),
                              valid[None].to(d)) for d in (device, 'cpu')]
    same = all(torch.equal(a.cpu(), b) for a, b in zip(matched[0][::2],
                                                       matched[1][::2]))
    log('phase6a anchor matching with 32 claims on one anchor: label {} on '
        'the card, {} on the CPU (31 expected), equal {}'.format(
            int(matched[0][0][0, 7]), int(matched[1][0][0, 7]), same))
    if not same or int(matched[0][0][0, 7]) != 31:
        failures.append('duplicate claims resolved differently')
    if failures:
        raise AssertionError('; '.join(failures))


def phase_shape_model(device):
    """phase6c: prepare_shape_model on the card (SHAPE_STEPS steps at
    SHAPE_BATCH, as tests/test_shape_model.py), saved, read back with the
    zoo's ``load_weights`` and built as tests/test_shape_model.py builds it
    (``build_detector(make_shape_config(), ...)``; the zoo's entry of that
    name is the 300x300 width-1.0 geometry, in the JAX package too), served
    under ``fused_exact``: a 50x50 black square on a
    96x96 white image is found as a rectangle with IoU > 0.25 among the top
    10, and each fixed_point_suppress launch of that step is held against
    its plain version."""
    import torch
    from watsor_tpu_torch.models.ssd import build_detector
    from watsor_tpu_torch.models.zoo import load_weights
    from watsor_tpu_torch.ops import nms_fixed_point
    from watsor_tpu_torch.ops.boxes import iou_matrix
    from watsor_tpu_torch.testing.prepare import (SHAPE_MODEL,
                                                  make_shape_config,
                                                  prepare_shape_model)
    from watsor_tpu_torch.testing.shapes import SHAPE_LABELS
    with tempfile.TemporaryDirectory() as model_dir:
        start = time.perf_counter()
        path, loss = prepare_shape_model(model_dir, steps=SHAPE_STEPS,
                                         batch=SHAPE_BATCH, device=device)
        train_s = time.perf_counter() - start
        size = os.path.getsize(path)
        detector = build_detector(
            make_shape_config()._replace(nms_mode='fused_exact'),
            variables=load_weights(model_dir, SHAPE_MODEL), device=device)
    image = np.full((1, 96, 96, 3), 255, np.uint8)
    image[0, 20:70, 25:75] = 0
    fp = nms_fixed_point.fixed_point_suppress
    calls = []
    fp.launches = 0
    with _recorded_kernels(calls):
        out = detector.detect_batch(torch.from_numpy(image).to(device))
        torch.cuda.synchronize()
    launches = fp.launches
    held = _hold_against_plain(calls)['fixed_point_suppress']
    gt = torch.tensor([[20 / 96, 25 / 96, 70 / 96, 75 / 96]], device=device)
    classes = out.classes[0][:10].cpu().numpy()
    ious = iou_matrix(out.boxes[0][:10], gt)[:, 0].cpu().numpy()
    hits = (classes == SHAPE_LABELS['rectangle']) & (ious > 0.25)
    log('phase6c shape model: {} steps at batch {} on the card and precise '
        'BN in {:.1f} s, final loss {:.4f}, {} ({} bytes) read by the '
        "zoo's load_weights ({}x{}); the square: {} detections, top-10 "
        'classes {} IoUs {}; fixed_point_suppress launches {} at {}, each '
        'bit-identical to its plain version'.format(
            SHAPE_STEPS, SHAPE_BATCH, train_s, loss, os.path.basename(path),
            size, detector.config.input_size, detector.config.input_size,
            int(out.valid[0]), classes.tolist(),
            [round(float(x), 2) for x in ious], launches, held))
    if not np.isfinite(loss) or not hits.any():
        raise AssertionError('no rectangle with IoU > 0.25 among the top 10')
    if launches < 1 or len(held) != launches:
        raise AssertionError('fixed_point_suppress launches {}, held {}'
                             .format(launches, len(held)))


def phase_sharded_train(device, card):
    """phase7a: the sharded train step of ssd_mobilenet_v2 at full width
    (bf16 activations, f32 parameters, AdamW at 1e-3) over [card] * 2
    (data 2) and [card] * 4 at model_parallel=2 (2 x 2), SHARDED_STEPS
    steps on one global batch of TRAIN_BATCH painted images: every loss
    finite and the last under TRAIN_FALL times the first."""
    import torch
    from watsor_tpu_torch.workload import (build_sharded_train,
                                           timed_train_steps)
    for label, n, model_size in SHARDED_MESHES:
        devices = [device] * n
        start = time.perf_counter()
        config, state, step, batch, images = build_sharded_train(
            devices, model_size)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - start
        torch.cuda.reset_peak_memory_stats(device)
        rows = timed_train_steps(state, step, batch, SHARDED_STEPS, devices)
        peak = torch.cuda.max_memory_allocated(device)
        losses = [row['loss'] for row in rows]
        wall = statistics.median(row['wall_ms'] for row in rows[1:])
        log('phase7a sharded train ssd_mobilenet_v2 {}x{} {} mesh {} ({} '
            'devices on the card, {} head kernels split over the model '
            'axis), global batch {}: build {:.2f} s, loss {:.4f} -> {:.4f} '
            'in {} steps, step wall median {:.3f} ms (after the first, '
            '{:.3f} ms), {:.1f} images/s, max_memory_allocated {:.3f} GB; '
            '{}'.format(config.input_size, config.input_size, config.dtype,
                        label, n, len(state.slices), images, build_s,
                        losses[0], losses[-1], len(losses), wall,
                        rows[0]['wall_ms'], images / wall * 1e3, peak / 1e9,
                        card))
        if not all(np.isfinite(losses)) or not losses[-1] < \
                TRAIN_FALL * losses[0]:
            raise AssertionError('mesh {}: losses {} do not fall under {} '
                                 'of the first'.format(label, losses,
                                                       TRAIN_FALL))
        del state, step, batch
        torch.cuda.empty_cache()


def phase_sharded_train_f64(device):
    """phase7b: one f64 step of ssd_mobilenet_v2 at full width with SGD at
    learning rate 1 (the update is the gradient), TF32 off, 4 painted
    images, over the 2 x 2 mesh [card] * 4 against the unsharded step on
    the card, from the same seeded weights (``_check_variables``): the loss
    within SHARDED_LOSS_RTOL relative, each new BatchNorm statistic within
    SHARDED_STATS_TOL and each gradient within SHARDED_GRAD_TOL of its
    leaf's largest magnitude, a leaf whose gradient is zero in exact
    arithmetic (under SHARDED_GRAD_TOL of the tree's largest) held under
    that share of the tree's largest; then every replica equal bit for
    bit."""
    import functools
    import torch
    from watsor_tpu_torch.models.train import (_model_for, init_train_state,
                                               make_train_step)
    from watsor_tpu_torch.models.weights import export_variables
    from watsor_tpu_torch.models.zoo import model_config
    from watsor_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from watsor_tpu_torch.workload import train_batch
    batch = train_batch(300, n=4)
    batch['gt_boxes'] = batch['gt_boxes'].astype(np.float64)
    variables = _check_variables()
    config = model_config('ssd_mobilenet_v2')._replace(dtype=torch.float64)
    sgd = functools.partial(torch.optim.SGD, lr=1.0)
    with tf32(False):
        single = init_train_state(config, variables, sgd,
                                  model=_model_for(config).to(torch.float64),
                                  device=device)
        before = dict(_flat(export_variables(single.model, np.float64)))
        want_loss = float(make_train_step(config)(single, batch)['loss'])
        want = dict(_flat(export_variables(single.model, np.float64)))
        mesh = make_mesh(devices=[device] * 4, model_parallel=2)
        state, step, shard_batch = make_sharded_train_step(
            mesh, config, init=variables, optimizer=sgd,
            model=_model_for(config).to(torch.float64))
        start = time.perf_counter()
        loss = float(step(state, shard_batch(batch))['loss'])
        seconds = time.perf_counter() - start
        got = dict(_flat(state.variables(np.float64)))
    loss_err = abs(loss - want_loss) / abs(want_loss)
    stats_err = max(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
                    for k in want if k.startswith('batch_stats/'))
    grads = {k: (before[k] - want[k], before[k] - got[k]) for k in want
             if k.startswith('params/')}
    tree_max = max(np.abs(w).max() for w, _ in grads.values())
    live = sorted(((np.abs(g - w).max() / np.abs(w).max(), k)
                   for k, (w, g) in grads.items()
                   if np.abs(w).max() >= SHARDED_GRAD_TOL * tree_max),
                  reverse=True)
    zero = max([np.abs(g).max() / tree_max for w, g in grads.values()
                if np.abs(w).max() < SHARDED_GRAD_TOL * tree_max] + [0.0])
    n_zero = sum(np.abs(w).max() < SHARDED_GRAD_TOL * tree_max
                 for w, _ in grads.values())
    replicas = [dict(_flat(tree)) for tree in
                state.replica_variables(np.float64).values()]
    equal = all(np.array_equal(tree[k], replicas[0][k])
                for tree in replicas[1:] for k in tree if k in replicas[0])
    log('phase7b sharded f64 train step (2 x 2 mesh on the card, {} head '
        'kernels split, TF32 off, SGD lr 1, 4 images) against the unsharded '
        'step on the card: loss {:.15g} / {:.15g}, relative {:.3g} (bar {}); '
        "new BatchNorm statistics against each leaf's largest {:.3g} (bar "
        "{}); gradient against each leaf's largest: worst {:.3g} (bar {}) "
        'at {}; {} leaves zero in exact arithmetic, under {:.3g} of the '
        "tree's largest; {} replica(s) equal bit for bit: {}; sharded step "
        '{:.2f} s'.format(len(state.slices), loss, want_loss, loss_err,
                          SHARDED_LOSS_RTOL, stats_err, SHARDED_STATS_TOL,
                          live[0][0], SHARDED_GRAD_TOL, live[0][1], n_zero,
                          zero, len(replicas), equal, seconds))
    failures = []
    if loss_err > SHARDED_LOSS_RTOL:
        failures.append('loss {:.3g}'.format(loss_err))
    if stats_err > SHARDED_STATS_TOL:
        failures.append('statistics {:.3g}'.format(stats_err))
    if live[0][0] > SHARDED_GRAD_TOL or zero >= SHARDED_GRAD_TOL:
        failures.append('gradients {:.3g}, zero leaves {:.3g}'.format(
            live[0][0], zero))
    if not equal:
        failures.append('replicas differ')
    if failures:
        raise AssertionError('; '.join(failures))


def phase_fleet_model_axis(device):
    """phase7c: the main path's detector (bf16, ``fused_exact``, fused
    blocks) behind FleetDetector over [card] * 4 at model_parallel=2 on
    MODEL_AXIS_PLANES detect planes: kernel 1 once and kernel 2 FUSED_CALLS
    times a data shard a step, each launch held against its plain version;
    the packed output against the data-only fleet's ([card] * 2) under
    match_records' rules (the same labels, IoU > 0.5, score within 5e-3),
    and whether it is bit-identical; then the f32 detector with TF32 off,
    its raw head outputs within F32_REL_TOL relative of the data-only
    fleet's."""
    import torch
    from watsor_tpu_torch.ops import fused_block, nms_fixed_point
    from watsor_tpu_torch.parallel import FleetDetector, make_mesh
    from watsor_tpu_torch.parallel.fleet import split_heads
    from watsor_tpu_torch.testing.golden import (detections_to_records,
                                                 match_records)
    from watsor_tpu_torch.workload import (build_main_path_detector,
                                           detect_planes)
    planes = detect_planes(MODEL_AXIS_PLANES, seed=4)
    model_mesh = make_mesh(devices=[device] * 4, model_parallel=2)
    data_mesh = make_mesh(devices=[device] * 2)
    detector = build_main_path_detector(device)
    fleet = FleetDetector(model_mesh, detector)
    data_only = FleetDetector(data_mesh, detector)
    counters = (nms_fixed_point.fixed_point_suppress,
                fused_block.fused_inverted_residual)
    fleet.detect(planes)
    torch.cuda.synchronize()
    calls = []
    with _recorded_kernels(calls):
        for counter in counters:
            counter.launches = 0
        got = fleet.detect(planes)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    shards = model_mesh.shape['data']
    if launches != {'fixed_point_suppress': shards,
                    'fused_inverted_residual': FUSED_CALLS * shards}:
        raise AssertionError('model-axis fleet launches {}'.format(launches))
    held = _hold_against_plain(calls)
    want = data_only.detect(planes)

    def records(outs):
        fields = ('boxes', 'scores', 'classes', 'valid')
        return detections_to_records(
            *(torch.cat([getattr(o, f) for o in outs]).cpu().numpy()
              for f in fields), top=100)

    problems = [p for e, g in zip(records(want), records(got))
                for p in match_records(e, g)]
    identical = all(torch.equal(getattr(a, f), getattr(b, f))
                    for a, b in zip(got, want)
                    for f in ('boxes', 'scores', 'classes', 'valid'))
    kept = sum(int(o.valid.sum()) for o in got)
    with tf32(False):
        f32 = build_main_path_detector(device, dtype=torch.float32)
        fleets = (FleetDetector(model_mesh, f32),
                  FleetDetector(data_mesh, f32))
        x = torch.from_numpy(planes).to(device).float() * (2.0 / 255.0) - 1.0
        size = len(planes) // shards
        errs = [0.0, 0.0]
        for i in range(shards):
            outs = []
            for one in fleets:
                with one.on_shard(i):
                    outs.append(one.replicas[i].raw_apply(
                        x[i * size:(i + 1) * size]))
            torch.cuda.synchronize()
            for j, (a, b) in enumerate(zip(*outs)):
                errs[j] = max(errs[j], float((a - b).abs().max() /
                                             b.abs().max()))
    log('phase7c model-axis fleet ({} x {} on the card, {} split heads a '
        'shard) batch {}: launches {} (this step alone), fixed_point_suppress '
        'at {} bit-identical to its plain version and the {} '
        'fused_inverted_residual launches within tolerance; bf16 packed '
        'output against the data-only fleet: {} detections, match_records '
        'problems {}, bit-identical {}; f32 (TF32 off) raw head outputs '
        'against the data-only fleet: box relative {:.3g}, class relative '
        '{:.3g} (bar {})'.format(
            shards, model_mesh.shape['model'],
            len(split_heads(detector, model_mesh, model_mesh.rows[0])),
            len(planes), launches,
            sorted(set(held['fixed_point_suppress'])),
            len(held['fused_inverted_residual']), kept, problems[:3],
            identical, errs[0], errs[1], F32_REL_TOL))
    if problems or max(errs) > F32_REL_TOL:
        raise AssertionError('model-axis fleet: {} problems, raw errors {}'
                             .format(len(problems), errs))


def phase_warmup(device):
    """phase7d: ``python -m watsor_tpu_torch.warmup -m ssd_mobilenet_v2 -b
    1 8`` (with WATSOR_FUSED_BLOCKS=1) twice into a new kernel build
    directory: the first run builds the four kernels, the second finds them
    built; both print each bucket's seconds and exit 0."""
    with tempfile.TemporaryDirectory() as cache:
        for run in ('first', 'second'):
            start = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, '-m', 'watsor_tpu_torch.warmup', '-m',
                 'ssd_mobilenet_v2', '-b', '1', '8', '--cache-dir', cache],
                cwd=ROOT, capture_output=True, text=True, timeout=600,
                env=dict(os.environ, WATSOR_FUSED_BLOCKS='1'))
            seconds = time.perf_counter() - start
            lines = proc.stdout.splitlines()
            kernels = [line for line in lines if line.startswith('kernel ')]
            buckets = [line for line in lines if line.startswith('batch ')]
            log('phase7d warmup, {} run: exit {}, {:.1f} s; {}; {}'.format(
                run, proc.returncode, seconds, kernels, buckets))
            if proc.returncode != 0:
                raise AssertionError('warmup exited {}:\n{}{}'.format(
                    proc.returncode, proc.stdout[-2000:],
                    proc.stderr[-4000:]))
            want = 'built in' if run == 'first' else 'found built'
            if len(kernels) != 4 or not all(want in k for k in kernels) or \
                    len(buckets) != 2:
                raise AssertionError('warmup {} run printed {}'.format(
                    run, lines))


def phase_converted_weights(device, card):
    """phase8a: the main path's seeded ssd_mobilenet_v2 tree (90 classes,
    full width) named as the public ssd_mobilenet_v2_coco_2018_03_29
    checkpoint names it (testing/slim.py), converted by the port's
    convert_tf_od_variables with no TensorFlow (the geometry inferred),
    saved by save_weights and read back by the zoo into the main-path
    detector (fused blocks, ``fused_exact``); the converted tree equals
    the seeded one bit for bit, and so do the detections on BATCH frames
    of 1920x1080, with kernel 1 once and kernel 2 FUSED_CALLS times a step,
    each launch held against its plain version."""
    import torch
    from watsor_tpu_torch.models import convert
    from watsor_tpu_torch.models.zoo import MODEL_REGISTRY, save_weights
    from watsor_tpu_torch.ops import fused_block, nms_fixed_point
    from watsor_tpu_torch.testing.slim import tf_od_variables
    from watsor_tpu_torch.workload import (MODEL, build_main_path_detector,
                                           frames_1080p)
    seeded = build_main_path_detector(device)
    names = tf_od_variables(seeded.variables, MODEL_REGISTRY[MODEL])
    start = time.perf_counter()
    tree, cfg = convert.convert_tf_od_variables(names)
    convert_s = time.perf_counter() - start
    geometry = (cfg.backbone, cfg.num_classes, cfg.head_kernel, cfg.lite)
    if geometry != ('mobilenet_v2', 90, 3, False):
        raise AssertionError('inferred geometry {}'.format(geometry))
    got, want = dict(_flat(tree)), dict(_flat(seeded.variables))
    if got.keys() != want.keys() or \
            not all(np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError('the converted tree differs from the seeded one')
    frames = frames_1080p(device)
    counters = (nms_fixed_point.fixed_point_suppress,
                fused_block.fused_inverted_residual)
    with tempfile.TemporaryDirectory() as model_dir:
        path = save_weights(tree, model_dir, MODEL)
        size = os.path.getsize(path)
        converted = build_main_path_detector(device, seed=1,
                                             model_path=model_dir)
    converted.detect_batch(frames)
    torch.cuda.synchronize()
    calls = []
    with _recorded_kernels(calls):
        for counter in counters:
            counter.launches = 0
        got = converted.detect_batch(frames)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    if launches != {'fixed_point_suppress': 1,
                    'fused_inverted_residual': FUSED_CALLS}:
        raise AssertionError('converted weights: launches {}'.format(
            launches))
    held = _hold_against_plain(calls)
    want = seeded.detect_batch(frames)
    torch.cuda.synchronize()
    _check_detections(got, BATCH, converted.config.max_detections)
    fields = ('boxes', 'scores', 'classes', 'valid')
    identical = all(torch.equal(getattr(got, f), getattr(want, f))
                    for f in fields)
    log('phase8a converted weights [{}]: {} checkpoint variables converted '
        'in {:.3f} s (no TensorFlow), geometry {}, tree bit-identical; '
        '.msgpack {} bytes read back by the zoo; detections on {} frames '
        'of 1920x1080 ({} kept) bit-identical to the seeded detector: {}; '
        'launches {} a step, fixed_point_suppress at {} bit-identical to '
        'its plain version, {} fused_inverted_residual launches within '
        'tolerance'.format(
            card, len(names), convert_s, geometry, size, BATCH,
            int(got.valid.sum()), identical, launches,
            held['fixed_point_suppress'],
            len(held['fused_inverted_residual'])))
    if not identical:
        raise AssertionError('converted weights: detections differ')


def phase_timing(device, card):
    """phase8b: the port's timing and roofline modules. (1)
    ``measure_production_device_path(batch=32)`` at 1920x1080: detect,
    filters, pack and overlay captured once as a CUDA graph and replayed,
    kernel 1 launched WARMUP_STEPS times eagerly and once into the graph;
    beside it the eager TorchDetectorBackend step wall on the same
    detector, tables and batch of host frames (H2D included). (2)
    ``chained_model_runner`` + ``chained_step_ms`` on the main path's
    detect step at batch BATCH against ``profile_step.graph_ms`` of the
    same step (a graph of 10 steps): within CHAINED_GRAPH_RTOL. (3) the
    roofline row of that step from ``step_cost`` on its plain walk
    (FlopCounterMode cannot see the hand-written kernels; the plain walk
    runs the same convolutions)."""
    import torch
    from watsor_tpu_torch import roofline, timing
    from watsor_tpu_torch.detection.backend import TorchDetectorBackend
    from watsor_tpu_torch.ops import nms_fixed_point
    from watsor_tpu_torch.profile_step import graph_ms
    from watsor_tpu_torch.workload import (FRAME_HW, build_main_path_detector,
                                           frames_1080p, step_wall_ms)
    fp = nms_fixed_point.fixed_point_suppress
    fp.launches = 0
    record = timing.measure_production_device_path(
        batch=PRODUCTION_BATCH, hw=FRAME_HW, n_cameras=PRODUCTION_BATCH,
        device=device)
    launches = fp.launches
    if launches != timing.WARMUP_STEPS + 1:
        raise AssertionError('production path: {} fixed_point_suppress '
                             'launches, {} expected'.format(
                                 launches, timing.WARMUP_STEPS + 1))
    detector = timing.build_production_detector(device)
    cameras = ['cam{}'.format(i) for i in range(PRODUCTION_BATCH)]
    tables = timing.production_tables(FRAME_HW)
    backend = TorchDetectorBackend(
        detector, device, camera_tables={c: tables for c in cameras})
    host = np.random.default_rng(8).integers(
        0, 256, (PRODUCTION_BATCH,) + FRAME_HW + (3,), np.uint8)
    wall = step_wall_ms(backend, host, cameras, reps=10)
    log('phase8b production path [{}]: {}; fixed_point_suppress launches '
        '{} ({} eager warm-up steps and 1 captured into the graph that the '
        'replays run); eager TorchDetectorBackend step wall at batch {} of '
        'host 1920x1080 frames (H2D included) {:.3f} ms, median of 10'
        .format(card, json.dumps(record), launches, timing.WARMUP_STEPS,
                PRODUCTION_BATCH, wall))
    del detector, backend, host
    torch.cuda.empty_cache()

    walk = build_main_path_detector(device)
    frames = frames_1080p(device)
    graph = graph_ms(lambda: walk.detect_batch(frames))
    run = timing.chained_model_runner(lambda _, x: walk.detect_batch(x),
                                      None, BATCH, FRAME_HW, device=device)
    chained, detail = timing.chained_step_ms(run)
    plain = build_main_path_detector(device, fused=False)
    flops, nbytes = roofline.step_cost(
        plain.detect_batch, frames,
        params=list(plain.model.state_dict().values()))
    row = roofline.roofline_row('ssd_mobilenet_v2 fused_exact C=2 (main '
                                'path)', BATCH, chained, flops, nbytes,
                                device)
    log('phase8b chained detect step [{}]: batch {} of 1920x1080 frames, '
        'main path (fused blocks, fused_exact): chained_step_ms {:.4f} ms '
        '(one captured step replayed; {}) against profile_step.graph_ms '
        '{:.4f} ms (a graph of 10 steps), ratio {:.4f} (bar 1 +- {})'
        .format(card, BATCH, chained, json.dumps(detail), graph,
                chained / graph, CHAINED_GRAPH_RTOL))
    log('phase8b roofline [{}]: step_cost of the plain walk: {} FLOP '
        '(FlopCounterMode), {} bytes (floor: frames, outputs, weights); '
        'row {}'.format(card, flops, nbytes, json.dumps(row)))
    if abs(chained / graph - 1.0) > CHAINED_GRAPH_RTOL:
        raise AssertionError('chained {} ms against graph {} ms'.format(
            chained, graph))
    if not flops or not nbytes or 'pct_speed_of_light' not in row:
        raise AssertionError('roofline row without peaks or counts: {}'
                             .format(row))


def phase_goldens(device, card):
    """phase9: every family of testing/golden.py GOLDEN_FAMILIES held to its
    seeded goldens on the card by ``golden.check_family`` (the f32 leg with
    TF32 off at the port's f32 bar, the production bf16 leg at labels and
    places, the f32 leg with TF32 on; each built once a NMS mode; kernel 1
    once a ``fused_exact`` step; the f32 bar catching both reduced-precision
    legs), one line a family; every kernel-1 launch of the phase held bit
    for bit against its plain version. Any problem fails the phase."""
    from watsor_tpu_torch.testing import golden
    batch, names = golden.load_photo_batch()
    stored = golden.load_goldens(golden.seeded_golden_path(
        golden.GOLDEN_FAMILIES[0], golden.GOLDEN_MODES[0]))['canvas_sha256']
    digest = golden.canvas_digest(batch)
    log('phase9 goldens [{}]: photo canvas {} of {}, sha256 {} the stored '
        'canvas\'s; f32 bar {}'.format(
            card, list(batch.shape), ', '.join(names),
            'equals' if digest == stored else 'DIFFERS from',
            golden.PORT_F32_SCORE_TOL))
    failed = []
    for family in golden.GOLDEN_FAMILIES:
        calls = []
        with _recorded_kernels(calls):
            row = golden.check_family(family, batch, names, device)
        held = _hold_against_plain(calls)['fixed_point_suppress']
        log('phase9 goldens {} [{}]: {}; {} fixed_point_suppress launches '
            'held bit for bit at {}'.format(family, card, json.dumps(row),
                                            len(held), sorted(set(held))))
        if not row['ok']:
            failed.append(family)
    if failed:
        raise AssertionError('goldens missed: {}'.format(', '.join(failed)))


def _bench_leg(phase, name, env, run, expected, launches, card):
    """One leg of the bench (phases 10 and 11): ``run()`` under ``env``
    (BENCH_CLEARED cleared besides), its launches of the four kernels
    counted from 0 and added to ``launches`` (by kernel, then by leg), each
    kernel's last INT8_CALLS launches recorded and held against their plain
    versions. Fails if a kernel of ``expected`` was not launched or not
    held. Returns (record, launches by kernel, shapes held by kernel)."""
    import torch
    from watsor_tpu_torch.measure import scoped_environ
    from watsor_tpu_torch.ops import (fused_block, int8_matmul,
                                      nms_fixed_point, nms_suppress)
    counters = (nms_fixed_point.fixed_point_suppress,
                fused_block.fused_inverted_residual,
                nms_suppress.pallas_suppress,
                int8_matmul.int8_matmul_requant)
    calls = []
    for counter in counters:
        counter.launches = 0
    with scoped_environ(dict(dict.fromkeys(BENCH_CLEARED), **env)), \
            _recorded_kernels(calls, keep=INT8_CALLS):
        record = run()
    torch.cuda.synchronize()
    counts = {c.__name__: c.launches for c in counters}
    shapes = {k: v for k, v in _hold_against_plain(calls).items() if v}
    held = {k: len(v) for k, v in shapes.items()}
    log(json.dumps({'phase': phase, 'leg': name, 'card': card,
                    'launches': counts, 'held': held, 'record': record}))
    for kernel, n in counts.items():
        launches.setdefault(kernel, {})['{} {}'.format(phase, name)] = n
    missing = [k for k in expected if not counts[k] or not held.get(k)]
    if missing:
        raise AssertionError('{}: {} not launched or not held'.format(
            name, ', '.join(missing)))
    return record, counts, shapes


def phase_bench(device, card, launches):
    """phase10: the port's measurement entry points (watsor_tpu_torch/
    bench.py) on the card, one JSON line a leg (``_bench_leg``). ``step``
    at batch 32 (BENCH_STEPS=10, BENCH_REPS=3): kernel 1 only in its
    device-path leg (timing.WARMUP_STEPS eager steps and one captured into
    the graph); ``app`` at BENCH_APP_CAMERAS synthetic 1080p cameras and
    BENCH_APP_DURATION s of samples on each path of BENCH_APP_PATHS, with
    its kernels. Any failed leg fails the phase."""
    import torch
    from watsor_tpu_torch import bench, timing
    from watsor_tpu_torch.io import native

    def leg(name, env, run, expected):
        return _bench_leg('phase10', name, env, run, expected, launches,
                          card)[:2]

    record, counts = leg('step', BENCH_STEP_ENV,
                         lambda: bench.run_step(device),
                         ('fixed_point_suppress',))
    if counts['fixed_point_suppress'] != timing.WARMUP_STEPS + 1:
        raise AssertionError('step: {} fixed_point_suppress launches, {} '
                             'expected'.format(counts['fixed_point_suppress'],
                                               timing.WARMUP_STEPS + 1))
    if record['device_path']['source'] != 'measured this run' or \
            'chained_fps' not in record or \
            'pct_speed_of_light' not in record or \
            not record['device'].startswith(torch.cuda.get_device_name(0)):
        raise AssertionError('step record incomplete: {}'.format(record))
    for path, env, nms, expected in BENCH_APP_PATHS:
        env = dict(env, BASELINE5_CAMERAS=str(BENCH_APP_CAMERAS),
                   BASELINE5_DURATION=str(BENCH_APP_DURATION),
                   BASELINE5_PORT=str(_free_port()),
                   BASELINE5_WARM_DEADLINE='300')
        record, _ = leg('app ' + path, env,
                        lambda: bench.run_app(device, nms=nms), expected)
        if not record['latency_ms_p50'] <= record['latency_ms_p95']:
            raise AssertionError('app {}: p50 above p95'.format(path))
        if not native.available() and (record['encoder_fps'] is not None or
                                       not record['notes']):
            raise AssertionError('app {}: the encoder without libav is not '
                                 'noted'.format(path))


def phase_measure(device, card, launches):
    """phase11: the measurement legs of watsor_tpu_torch/measure/ (``bench
    host|nms|int8|overlap|models|overlay|restart``) on the card at fewer
    steps, one JSON line a leg (``_bench_leg``): ``nms`` launches kernel 1
    under fused_exact and kernel 3 under exact at C = 90 and C = 2,
    ``int8`` kernel 4 under its pallas mode (every mode's scores within
    cosine INT8_MIN_COSINE of the bf16 step's, and after the leg each
    mode's raw outputs within it of the f32 plain model's, as phase 2);
    ``restart``'s cold child
    builds the four kernels and its restart child finds them. Any failed
    leg fails the phase."""
    from watsor_tpu_torch.measure import (host_budget, int8_full, nms_modes,
                                          overlap, overlay, roofline_table,
                                          warm_restart)

    def leg(name, env, run, expected=()):
        return _bench_leg('phase11', name, env, run, expected, launches,
                          card)

    # first: the MQTT stages' keep-alive threads end within a minute
    record, _, _ = leg('host', {}, lambda: host_budget.measure(device,
                                                               log=log))
    stages = record['per_stage_ms_per_frame']
    if not all(v > 0 for v in stages.values()) or \
            list(stages) != list(host_budget.STAGES):
        raise AssertionError('host: stages {}'.format(stages))

    record, _, shapes = leg(
        'nms', MEASURE_STEP_ENV, lambda: nms_modes.measure(device, log=log),
        tuple(MEASURE_NMS_SHAPES))
    by_shape = {k: {str(shape): v.count(shape) for shape in set(v)}
                for k, v in shapes.items()}
    log(json.dumps({'phase': 'phase11', 'leg': 'nms',
                    'launches_by_shape': by_shape}))
    for kernel, wanted in MEASURE_NMS_SHAPES.items():
        for shape in wanted:
            if shape not in shapes.get(kernel, []):
                raise AssertionError('nms: {} not launched at {}'.format(
                    kernel, shape))
    if len(record['active']) != 6 or not all(
            row['ms'] > 0 and row['chained_ms_per_step'] > 0
            for row in record['active'].values()):
        raise AssertionError('nms record incomplete: {}'.format(record))

    quantized = []
    record, _, _ = leg('int8', MEASURE_STEP_ENV,
                       lambda: int8_full.measure(
                           device, log=log,
                           built=lambda m, q: quantized.append((m, q))),
                       ('int8_matmul_requant',))
    # bench_int8_full.py's bar; with seeded random weights the kept scores
    # are all near one value and it reads about 1 whatever the walk computes
    low = {m: record[m]['scores_cosine_vs_bf16'] for m in int8_full.MODES
           if record[m]['scores_cosine_vs_bf16'] < INT8_MIN_COSINE}
    if low:
        raise AssertionError('int8: scores cosine under {}: {}'.format(
            INT8_MIN_COSINE, low))
    # the bar that tells a wrong walk: each mode's raw outputs against the
    # f32 plain model's, as phase 2 holds the pallas path's (after the leg,
    # so its launches are neither counted nor held)
    for mode, qdetector in quantized:
        log('int8 leg, mode {}:'.format(mode))
        phase_int8_reference(device, qdetector)
    del quantized

    record, _, _ = leg('overlap', {}, lambda: overlap.measure(
        device, batches=MEASURE_OVERLAP_BATCHES, log=log))
    if [r['batch'] for r in record['rows']] != \
            list(MEASURE_OVERLAP_BATCHES) or \
            record['marginal_ms_per_frame'] is None:
        raise AssertionError('overlap record incomplete: {}'.format(record))

    record, _, _ = leg('models', MEASURE_STEP_ENV,
                       lambda: roofline_table.measure(
                           device, names=MEASURE_MODELS, log=log))
    for name in MEASURE_MODELS:
        row = record['models'][name]
        if 'pct_speed_of_light' not in row or \
                not row['chained_ms_per_step'] > 0:
            raise AssertionError('models: {} incomplete: {}'.format(
                name, row))

    record, _, _ = leg('overlay', {}, lambda: overlay.measure(
        device, *MEASURE_OVERLAY, log=log))
    if not record['frames_per_s'] > 0:
        raise AssertionError('overlay: {}'.format(record))

    record, _, _ = leg('restart', {},
                       lambda: warm_restart.measure(device, log=log))
    cold, warm = record['cold']['kernels'], record['restart']['kernels']
    if len(cold) != 4 or None in cold.values() or \
            set(warm) != set(cold) or any(v is not None
                                          for v in warm.values()) or \
            record['cache_entries'] < 4:
        raise AssertionError('restart: the cold leg must build the four '
                             'kernels and the restart leg find them: {}'
                             .format(record))


def _lite4_nms_inputs(device):
    """Decoded boxes and f32 sigmoid scores [BATCH, A, 90] on
    efficientdet_lite4's anchors (A = 76,725), from box encodings uniform
    in [-1, 1] and bf16 logits uniform in [-6, 1] (the detect step's dtype,
    as profile_lite4.py draws them) from seed 0; returns (box_enc, logits,
    anchors, scales, boxes, scores). f32 sigmoid is one to one on bf16
    logits, so the early form's union (by score) and the late form's (by
    logit) tie alike; on f32 logits this dense, neighbours within a few
    ulps of 1 share a score and the two unions' tie orders part."""
    import torch
    from watsor_tpu_torch.models.efficientdet import (effdet_anchors,
                                                      lite_config)
    from watsor_tpu_torch.ops.boxes import decode_boxes
    cfg = lite_config('lite4')
    scales = tuple(cfg.box_coder_scales)
    anchors = torch.from_numpy(effdet_anchors(cfg)).to(device)
    g = torch.Generator(device=device).manual_seed(0)
    A = anchors.shape[0]
    box_enc = torch.rand((BATCH, A, 4), generator=g, device=device) * 2 - 1
    logits = (torch.rand((BATCH, A, cfg.num_classes), generator=g,
                         device=device) * 7 - 6).to(torch.bfloat16)
    return (box_enc, logits, anchors, scales,
            decode_boxes(box_enc, anchors, scales=scales),
            torch.sigmoid(logits.float()))


def _fused_nms_early(device):
    """The per-class entry under its three fused modes (the early fused
    form) at Lite4's scale: kernel 1 once a call in both greedy modes and
    never under ``fused``; each output against the late form on the
    encodings and logits behind it (classes and counts exact, floats within
    EARLY_LATE_ATOL); bf16 scores through ``fused_exact`` (kernel 1 on
    their exact f32 widening, the scores returned in bf16); then, with
    LITE4_LIVE_ANCHORS anchors an image scored and the rest at 0, so that
    the union covers every candidate, ``fused_exact`` equal to the classic
    ``exact`` (kernel 3) in every output (tests/test_nms_semantics.py:78;
    the live scores all distinct, as that test's are, since the two merges
    order equal scores of one class by different indices). Returns the
    record."""
    import torch
    from watsor_tpu_torch.ops import nms, nms_fixed_point
    box_enc, logits, anchors, scales, boxes, scores = \
        _lite4_nms_inputs(device)
    fp = nms_fixed_point.fixed_point_suppress
    record = {'shape': list(scores.shape)}
    for mode, suppression in nms.FUSED_SUPPRESSION.items():
        before = fp.launches
        early = nms.batched_class_aware_nms(boxes, scores, mode=mode)
        torch.cuda.synchronize()
        launched = fp.launches - before
        if launched != int(suppression != 'fast'):
            raise AssertionError('{}: {} fixed_point_suppress launches'
                                 .format(mode, launched))
        late = nms.batched_class_aware_nms_fused_late(
            box_enc, logits, anchors, scales=scales, suppression=suppression)
        if not (torch.equal(early[2], late[2]) and
                torch.equal(early[3], late[3])):
            raise AssertionError('{}: early and late classes or counts '
                                 'differ'.format(mode))
        gap = max(float((e - l).abs().max()) for e, l in zip(early[:2],
                                                             late[:2]))
        if gap > EARLY_LATE_ATOL:
            raise AssertionError('{}: early against late {}'.format(mode,
                                                                   gap))
        record[mode] = {'launches': launched, 'valid': early[3].tolist(),
                        'early_vs_late_max_abs': gap}
    before = fp.launches
    out = nms.batched_class_aware_nms(boxes, scores.to(torch.bfloat16),
                                      mode='fused_exact')
    torch.cuda.synchronize()
    if fp.launches - before != 1 or out[1].dtype != torch.bfloat16 or \
            not bool(torch.isfinite(out[1].float()).all()):
        raise AssertionError('fused_exact on bf16 scores: {} launches, '
                             'scores {}'.format(fp.launches - before,
                                                out[1].dtype))
    record['fused_exact_bf16_valid'] = out[3].tolist()
    g = torch.Generator(device=device).manual_seed(1)
    B, A, C = scores.shape
    n = LITE4_LIVE_ANCHORS * C
    sparse = torch.zeros_like(scores)
    for b in range(BATCH):
        anchors_b = torch.randperm(A, generator=g, device=device)[
            :LITE4_LIVE_ANCHORS]
        ranks = torch.randperm(n, generator=g, device=device) + 1
        sparse[b, anchors_b] = (ranks.float() / (n + 1)).view(-1, C)
    exact = nms.batched_class_aware_nms(boxes, sparse, mode='exact')
    fused = nms.batched_class_aware_nms(boxes, sparse, mode='fused_exact')
    for name, e, f in zip(('boxes', 'scores', 'classes', 'valid'), exact,
                          fused):
        if not torch.equal(e, f):
            raise AssertionError('fused_exact against exact, union '
                                 'covering: {} differ'.format(name))
    record['covering_union_valid'] = exact[3].tolist()
    return record


def phase_lite4(device, card, launches):
    """phase12: the early fused NMS (``_fused_nms_early``) and ``bench
    lite4`` on efficientdet_lite4 at 640x640 (LITE4_ENV), one JSON line a
    leg (``_bench_leg``: each leg's launches counted from 0, kernel 1's and
    kernel 3's held bit for bit against their plain versions). Every row
    of the record finite and positive, its eight stage rows; after the
    leg, on efficientdet_lite4 built as the leg builds it, the backbone ->
    fpn -> heads chain over the model's own submodules equal to
    ``raw_apply`` bit for bit on a seeded bf16 batch.
    Any failed check fails the phase."""
    import math
    import torch
    from watsor_tpu_torch.measure import lite4
    from watsor_tpu_torch.models.zoo import build_from_zoo

    _bench_leg('phase12', 'fused nms', {}, lambda: _fused_nms_early(device),
               ('fixed_point_suppress', 'pallas_suppress'), launches, card)
    record, _, _ = _bench_leg(
        'phase12', 'lite4', LITE4_ENV, lambda: lite4.measure(device, log=log),
        (), launches, card)
    rows = [record[part] for part in lite4.PARTS if part != 'stages'] + \
        record['stages']
    bad = [row for row in rows for key in ('ms_per_step',
                                           'chained_ms_per_step')
           if not (math.isfinite(row[key]) and row[key] > 0)]
    if bad or len(record['stages']) != 8 or record['anchors'] != 76725:
        raise AssertionError('lite4 record: rows {} not finite and '
                             'positive, {} stage rows'.format(
                                 bad, len(record['stages'])))
    detector = build_from_zoo('efficientdet_' + lite4.VARIANT, None,
                              device=device)
    section = lite4.sections(detector)
    size = detector.config.input_size
    g = torch.Generator(device=device).manual_seed(2)
    x = (torch.rand((BATCH, size, size, 3), generator=g, device=device) * 2 -
         1).to(detector.config.dtype)
    with torch.inference_mode():
        chain = section['heads'](section['fpn'](section['backbone'](x)))
        whole = detector.raw_apply(x)
    torch.cuda.synchronize()
    same = [torch.equal(c, w) for c, w in zip(chain, whole)]
    log('phase12 lite4 [{}]: backbone -> fpn -> heads against raw_apply on '
        '{} x {}x{} bf16: box_enc {}, logits {}'.format(
            card, BATCH, size, size, *('bit-identical' if ok else 'DIFFERS'
                                       for ok in same)))
    if not all(same):
        raise AssertionError('lite4: the section chain differs from '
                             'raw_apply')


def _jax_modules():
    """Modules of JAX, and of the JAX package, that this process imported
    (``watsor_tpu`` and its submodules, not ``watsor_tpu_torch``)."""
    return sorted(name for name in sys.modules
                  if name.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                            'watsor_tpu'))


def _threads_left(grace_s=30.0):
    """Threads other than this one still running after every phase ended,
    given ``grace_s`` to finish; each one's stack goes to stderr."""
    deadline = time.time() + grace_s
    for thread in threading.enumerate():
        if thread is not threading.current_thread():
            thread.join(max(deadline - time.time(), 0.0))
    frames = sys._current_frames()
    alive = [t for t in threading.enumerate()
             if t is not threading.current_thread()]
    for thread in alive:
        frame = frames.get(thread.ident)
        print('thread {} still running:\n{}'.format(
            thread.name, ''.join(traceback.format_stack(frame)) if frame
            else ''), file=sys.stderr, flush=True)
    return sorted(t.name for t in alive)


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

    device = torch.device('cuda', 0)
    log('python {}, torch {}, CUDA {}'.format(
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    from watsor_tpu_torch.workload import card_label
    card = card_label(device)
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
    state = {'launches': {}, 'bench': {}}

    def main_path():
        state['detector'], launches, batches = phase_pipeline(
            (nms_fixed_point.fixed_point_suppress,
             fused_block.fused_inverted_residual),
            build_main_path_detector, 'phase2 pipeline (main path)')
        state['launches'].update(launches)
        n = launches['fused_inverted_residual']
        if n % FUSED_CALLS or n < FUSED_CALLS * batches:
            raise AssertionError('{} fused_inverted_residual launches for {} '
                                 'batches; {} a forward expected'.format(
                                     n, batches, FUSED_CALLS))

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

    def phase1():
        with tf32(False):
            phase_kernels(device, results)

    # (name, run, the phase it needs)
    phases = [
        ('phase1 kernels', phase1, None),
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
                           nms='exact'), None),
        ('phase3 application (efficientdet_lite0)',
         lambda: phase_app('phase3 application (efficientdet_lite0, 8 '
                           'synthetic cameras)',
                           {'WATSOR_QUANTIZE': None,
                            'WATSOR_INT8_POINTWISE': None},
                           model='efficientdet_lite0', cameras=BATCH), None),
        ('phase4 families', lambda: phase_families(device), None),
        ('phase4 families exact', lambda: phase_families_exact(device),
         None),
        ('phase5a overlay', lambda: phase_overlay(device), None),
        ('phase5b fleet', lambda: phase_fleet(device), None),
        ('phase5c fleet application',
         lambda: phase_app('phase5c application (WATSOR_FLEET=1, {} '
                           'synthetic cameras)'.format(FLEET_CAMERAS),
                           {'WATSOR_FLEET': '1', 'WATSOR_FUSED_BLOCKS': '1',
                            'WATSOR_QUANTIZE': None,
                            'WATSOR_INT8_POINTWISE': None},
                           cameras=FLEET_CAMERAS,
                           inspect=lambda app, url: fleet_app_check(
                               app, url, FLEET_CAMERAS)), None),
        ('phase6a train', lambda: phase_train(device, 'ssd_mobilenet_v2',
                                              'phase6a'), None),
        ('phase6a train f32', lambda: phase_train_f32(device), None),
        ('phase6b train', lambda: phase_train(device, 'efficientdet_lite0',
                                              'phase6b'), None),
        ('phase6c shape model', lambda: phase_shape_model(device), None),
        ('phase7a sharded train', lambda: phase_sharded_train(device, card),
         None),
        ('phase7b sharded train f64',
         lambda: phase_sharded_train_f64(device), None),
        ('phase7c model-axis fleet', lambda: phase_fleet_model_axis(device),
         None),
        ('phase7d warmup', lambda: phase_warmup(device), None),
        ('phase8a converted weights',
         lambda: phase_converted_weights(device, card), None),
        ('phase8b timing and roofline', lambda: phase_timing(device, card),
         None),
        ('phase9 goldens', lambda: phase_goldens(device, card), None),
        ('phase10 bench',
         lambda: phase_bench(device, card, state['bench']), None),
        ('phase11 measure',
         lambda: phase_measure(device, card, state['bench']), None),
        ('phase12 lite4', lambda: phase_lite4(device, card, state['bench']),
         None)]
    start = time.perf_counter()
    for name, run, needs in phases:
        if needs in failures:
            failures.append(name)
            log('{} SKIPPED: {} failed'.format(name, needs))
            continue
        phase_start = time.perf_counter()
        try:
            run()
        except Exception:
            traceback.print_exc()
            failures.append(name)
            log('{} FAILED'.format(name))
        log('{}: {:.1f} s'.format(name, time.perf_counter() - phase_start))
    log('phases: {:.1f} s'.format(time.perf_counter() - start))
    alive = _threads_left()
    log('threads still running: {}'.format(', '.join(alive) or 'none'))
    if alive:
        failures.append('threads')
    jax_modules = _jax_modules()
    if jax_modules:
        failures.append('no-jax check')
        log('chip_smoke: the port imported {}'.format(', '.join(jax_modules)))
    if failures:
        log('chip_smoke: failed phases: {}'.format(', '.join(failures)))
        return 1
    # each kernel's launches in its own path's run (phase 2); beside them,
    # by run, those of the bench's legs (phases 10 to 12), counted from 0
    # before each run
    for entry in results:
        entry['launches'] = state['launches'][entry['name']]
        entry['launches_by_run'] = dict(
            {'phase2': entry['launches']}, **state['bench'][entry['name']])
    log(json.dumps({'kernels': [
        {key: entry[key] for key in ('name', 'route', 'source', 'replaces',
                                     'launches', 'launches_by_run',
                                     'max_abs_err', 'ms', 'plain_ms',
                                     'bound_ms', 'bound_by', 'library_ms')}
        for entry in results]}))
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
