"""Device timing of the detection path by chained steps (counterpart of
watsor_tpu/timing.py).

A runner is a function ``run(seed, n)`` that makes its input on the device
from ``seed`` (an explicit ``torch.Generator``), runs ``n`` data-chained
steps of the work under test (step i + 1's input carries a value derived
from step i's output, so the steps run one after another) and returns a
scalar that the host fetches. ``chained_step_ms`` times two loop lengths,
each call with a fresh seed, and differences them: the input's generation,
the fetch and the host's constant cost cancel, leaving the time of a step.

On the card a runner captures its step once as a CUDA graph (static
buffers, on the runner's own stream) and replays it ``n`` times, the
counterpart of the JAX package's one jitted ``fori_loop``: what is timed
is the device's work, not the host's eager launches. A failed capture
raises; nothing falls back to eager launches on the card. On the CPU,
which has no graphs, a runner loops eagerly (the tests' path).

The carry is a scalar, not the frames. The full-path runner adds it to
the frames made from the seed (``img = img0 + dep``), as the JAX runners
do. The other runners add it to the input's first element alone, in place
in a copy of the input: a whole-input add would be one more pass over the
input a step, which a small part's time does not hold.
"""

from time import perf_counter

import numpy as np
import torch

# CUDA: steps run eagerly on the runner's stream before the capture, so
# that lazily built kernels and cuDNN's algorithm choices are settled
WARMUP_STEPS = 2


# copied from watsor_tpu/timing.py:33-79
def chained_step_ms(run, n_short=2, n_long=32, reps=5,
                    seed_base=1000, log=None):
    """Measure the per-step time of a chained runner.

    ``run(seed, n) -> scalar`` makes its input from ``seed``, runs ``n``
    data-chained steps and returns a scalar derived from the chain (see
    the module docstring); its first call may capture the step.

    Returns ``(ms_per_step, detail)`` where detail carries the raw
    short/long wall times and the first call's time (``compile_s``: the
    capture and a first execution). The reported value is ``(min(long) -
    min(short)) / (n_long - n_short)``: the minimum over reps bounds the
    host's jitter from above, and the long loop amortizes what remains.
    """
    detail = {'n_short': n_short, 'n_long': n_long, 'reps': reps}

    t0 = perf_counter()
    float(run(seed_base, n_short))      # capture + first execution
    detail['compile_s'] = round(perf_counter() - t0, 1)
    if log:
        log('compiled in %.0fs' % detail['compile_s'])

    def timed(n, tag):
        times = []
        for r in range(reps):
            seed = seed_base + 1 + n * 1000 + r   # never reused
            t0 = perf_counter()
            float(run(seed, n))         # scalar fetch forces completion
            times.append(perf_counter() - t0)
        detail['times_%s_s' % tag] = [round(t, 4) for t in times]
        if log:
            log('chained n=%d: %s' % (n, detail['times_%s_s' % tag]))
        return min(times)

    t_short = timed(n_short, 'short')
    t_long = timed(n_long, 'long')
    ms = (t_long - t_short) * 1000.0 / (n_long - n_short)
    return ms, detail


def seeded_frames(batch, hw, device):
    """``make_input`` of uint8 [batch, H, W, 3] frames from the seed."""
    h, w = hw

    def make_input(g):
        return torch.randint(0, 255, (batch, h, w, 3), generator=g,
                             dtype=torch.uint8, device=device)

    return make_input


def _chained_runner(body, make_input, device, whole_input=True):
    """``run(seed, n)`` over ``body(img) -> (dep, increment)``: ``img`` is
    ``make_input(generator)`` from the seed (uint8 frames for a detect
    step) plus the carried ``dep`` (a scalar tensor of its dtype), added
    to every element (``whole_input``) or to the first alone, and the
    runner returns the sum of the ``n`` f32 increments."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == 'cuda' else None
    state = {}

    def carried():
        if whole_input:
            return state['img0'] + state['dep']
        img, first = state['img'], (0,) * state['img'].dim()
        img[first].copy_(state['img0'][first] + state['dep'])
        return img

    def step():
        dep, increment = body(carried())
        state['dep'].copy_(dep)
        state['acc'].add_(increment)

    def capture():
        for _ in range(WARMUP_STEPS):
            step()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            step()
        return graph

    @torch.inference_mode()
    def run(seed, n):
        g = torch.Generator(device=device).manual_seed(int(seed))
        with torch.cuda.stream(stream):         # no-op on the CPU
            img0 = make_input(g)
            if not state:
                state.update(img0=img0, img=img0.clone(),
                             dep=torch.zeros((), dtype=img0.dtype,
                                             device=device),
                             acc=torch.zeros((), dtype=torch.float32,
                                             device=device))
                if stream is not None:
                    state['graph'] = capture()
            state['img0'].copy_(img0)
            state['img'].copy_(img0)
            state['dep'].zero_()
            state['acc'].zero_()
            for _ in range(n):
                if stream is None:
                    step()
                else:
                    state['graph'].replay()
            return state['acc'].item()

    return run


def chained_full_path_runner(detect_batch, params, tables, row_idx,
                             batch, hw, device=None):
    """``run(seed, n)`` for the COMPLETE production device path, every
    device stage the serving pipeline chains a tick:

      1080p-ingest detect (device resize + normalize + forward + box
      decode + NMS) -> per-camera filter cascade selected by ``row_idx``
      (confidence/area/zone-SAT, ops/filter_device.py) -> packed
      single-fetch transport (detection/backend.py ``pack_outputs``) ->
      batched box-overlay render (ops/overlay.py ``render_boxes``).

    ``detect_batch(params, img)`` returns a DetectionsBatch. The carry
    makes the steps sequential (step i + 1's input adds a value derived
    from step i's outputs) and the accumulator reduces BOTH the packed
    transport and the rendered pixels, so every stage's result is used.
    The rendered-frame reduction reads one uint8 frame batch again a step,
    a small overstatement of the step time.

    ``tables``: the stacked per-camera (conf, area, zone_sat, zone_allow)
    tensors on the device (the backend's table store layout); ``row_idx``:
    [batch] camera rows. ``device`` (None: the current CUDA device; 'cpu'
    for the CPU) is where the frames are made.
    """
    from watsor_tpu_torch.config.coco import COCO_COLOR_TABLE
    from watsor_tpu_torch.detection.backend import pack_outputs
    from watsor_tpu_torch.models.ssd import resolve_device
    from watsor_tpu_torch.ops.filter_device import \
        apply_filters_device_indexed
    from watsor_tpu_torch.ops.overlay import pixel_index, render_boxes

    device = resolve_device(device)
    h, w = (hw, hw) if isinstance(hw, int) else hw
    color_table = torch.from_numpy(np.asarray(COCO_COLOR_TABLE,
                                              np.uint8)).to(device)
    scale = torch.tensor([h, w, h, w], dtype=torch.float32, device=device)
    row_idx = torch.as_tensor(row_idx).to(device, torch.int32)
    index = pixel_index(h, w, device)

    def body(img):
        out = detect_batch(params, img)
        scores, classes, zones_hit, valid = apply_filters_device_indexed(
            out.boxes, out.scores, out.classes, *tables, row_idx)
        packed = pack_outputs(out.boxes, scores, classes, valid, zones_hit)
        rendered = render_boxes(img, out.boxes * scale, classes,
                                color_table, index=index)
        # full reductions: every pixel of the render and every field of the
        # transport feed the carry
        render_sum = rendered.sum(dtype=torch.int64)
        packed_sum = packed.sum()
        dep = (render_sum % 2).to(torch.uint8) + \
            (packed_sum * 0).to(torch.uint8)
        return dep, packed_sum + render_sum.float()

    return _chained_runner(body, seeded_frames(batch, (h, w), device), device)


def build_production_detector(device):
    """The north-star serving detector on ``device``: SSD-MobileNet-v2
    (random weights from seed 0), fused_exact NMS, active labels {person,
    car}."""
    from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
    return build_detector(SSDConfig(nms_mode='fused_exact',
                                    active_labels=(1, 3)), device=device)


def production_tables(hw):
    """One camera's (conf, area, zone_sat, zone_allow) filter tables at
    frames of ``hw``: a real two-zone mask and the demo detect config,
    hence genuine SAT tables."""
    from watsor_tpu_torch.filters.mask import ZoneMask
    from watsor_tpu_torch.ops.filter_device import (threshold_tables,
                                                    zone_tables)
    h, w = hw
    alpha = np.zeros((h, w), np.uint8)
    alpha[h // 8: h // 2, w // 8: w // 2] = 255
    alpha[h // 2 + 40: h - 40, w // 2 + 40: w - 40] = 255
    zone_mask = ZoneMask(alpha, (h, w))
    cfg = [{'person': {'confidence': 60, 'area': 10, 'zones': [1, 2]}},
           {'car': {'confidence': 60, 'area': 10, 'zones': []}}]
    return threshold_tables(cfg) + zone_tables(zone_mask, cfg)


def measure_production_device_path(batch=32, hw=(1080, 1920),
                                   n_short=2, n_long=32, reps=5,
                                   n_cameras=32, log=None, device=None):
    """Build the north-star serving program (SSD-MobileNet-v2, fused_exact
    NMS, active labels {person, car}, zones configured) on ``device``
    (None: the current CUDA device; 'cpu' for the CPU) and time the FULL
    device path with the chained harness. Returns the JAX package's record
    (its north star, 32 cameras at 30 frames/s = 960 frames/s, is that
    record's constant, not a figure of the card)."""
    from watsor_tpu_torch.models.ssd import resolve_device

    device = resolve_device(device)
    det = build_production_detector(device)
    tables = tuple(torch.from_numpy(np.stack([t] * n_cameras)).to(device)
                   for t in production_tables(hw))
    row_idx = np.arange(batch, dtype=np.int32) % n_cameras

    run = chained_full_path_runner(lambda _, img: det.detect_batch(img),
                                   None, tables, row_idx, batch, hw,
                                   device=device)
    ms, detail = chained_step_ms(run, n_short=n_short, n_long=n_long,
                                 reps=reps, log=log)
    fps = batch * 1000.0 / ms
    return {
        'metric': 'full device path (1080p detect + per-camera filters + '
                  'zone SATs + pack + overlay render), chained, batch %d'
                  % batch,
        'model': 'ssd_mobilenet_v2 fused_exact C=2',
        'batch': batch, 'ingest': '%dx%d' % (hw[1], hw[0]),
        'ms_per_step': round(ms, 3),
        'fps': round(fps, 1),
        'north_star_fps': 960.0,
        'vs_north_star': round(fps / 960.0, 2),
        'device': torch.cuda.get_device_name(device)
        if device.type == 'cuda' else str(device),
        'detail': detail,
    }


def chained_model_runner(step, params, batch, size, device=None):
    """Standard ``run(seed, n)`` for a detector ``detect_batch`` step
    called as ``step(params, img)``: uint8 [batch, H, W, 3] input from the
    seed (``size`` is an int for square inputs or an (H, W) tuple) on
    ``device`` (None: the current CUDA device; 'cpu' for the CPU), chained
    through a zero scalar derived from each step's scores (``out[1]``)."""
    from watsor_tpu_torch.models.ssd import resolve_device

    h, w = (size, size) if isinstance(size, int) else size
    device = resolve_device(device)
    return chained_input_runner(lambda img: step(params, img)[1],
                                seeded_frames(batch, (h, w), device), device)


def chained_input_runner(step, make_input, device=None):
    """``run(seed, n)`` for ``step(x)`` (a detect step, or a part of one),
    whose input ``x`` is ``make_input(generator)`` (any dtype), chained
    through a zero scalar derived from the first element of its output (of
    its first output, where it returns several tensors), added to the
    input's first element alone."""
    from watsor_tpu_torch.models.ssd import resolve_device

    def body(x):
        out = step(x)
        out = out if isinstance(out, torch.Tensor) else out[0]
        first = out[(0,) * out.dim()].float()     # no copy of a view
        return (first * 0).to(x.dtype), first

    return _chained_runner(body, make_input, resolve_device(device),
                           whole_input=False)
