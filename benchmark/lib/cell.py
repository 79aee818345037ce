"""One run of one cell: set-up (weights and frames drawn from the seed on
the device, the program built and warmed at the cell's buckets), the
measured window, the comparison with the reference once the program is
freed, and the result line.

Set-up runs from the process's start to the window's first dispatch. Only
the traced run profiles, over the window's last ``trace_seconds``; the
host-clock readers then read the window before that slice.
"""

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from benchmark.lib import check, plain, post, program, stats, trace
from benchmark.lib.drive import Driver, Record

# the backend's padded batch sizes (watsor_tpu_torch/detection/backend.py)
BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# frames that calibrate the drawn weights (``plain.calibrate``)
CALIBRATION_FRAMES = 4
# a frame's rectangles, their sides (shares of the frame) and its noise
SHAPES = 12
SIDES = (0.05, 0.45)
NOISE = 8
# top-level modules that no run may load
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'watsor_tpu')


def bucket(n):
    for b in BUCKETS:
        if n <= b:
            return b
    return -(-n // 32) * 32


def forbidden_modules():
    """The forbidden top-level names among the loaded modules, each module
    compared by its whole top-level name."""
    return sorted({name.split('.')[0] for name in sys.modules} &
                  set(FORBIDDEN))


def schedule(traffic, seconds, rng):
    """(due s, senders) of an open loop: each camera at the traffic's
    rate, the cameras' phases spread evenly over one frame interval and
    dealt to the cameras in a seeded order, so that every seed has the
    same arrivals."""
    n, fps = traffic['cameras'], traffic['fps']
    phase = rng.permutation(n) / (n * fps)
    frames = int(np.ceil(seconds * fps)) + 1
    due = phase[:, None] + np.arange(frames)[None, :] / fps
    camera = np.broadcast_to(np.arange(n)[:, None], due.shape)
    keep = due < seconds
    due, camera = due[keep], camera[keep]
    order = np.lexsort((camera, due))
    names = camera_names(n)
    return due[order], [names[c] for c in camera[order]]


def weights_and_frames(cell, seed, device):
    """(leaves, flat f32 weights on the host, frame pool) of ``seed``: the
    weights drawn on the device and calibrated there on the pool's first
    frames, in f32 with TF32 off; the frames after them from the same
    generator."""
    cfg, traffic = cell.config, cell.traffic
    ref = cell.reference()
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    leaves = plain.layout(ref.forward, cfg, cfg['input_size'])
    flat, tree = plain.seeded_tree(leaves, generator, device)
    pool = frame_pool(traffic, cfg['input_size'], generator, device)
    with no_tf32(), torch.no_grad():
        plain.calibrate(ref.forward, tree, leaves, cfg,
                        pool[:CALIBRATION_FRAMES].float())
    return leaves, flat.cpu().numpy(), pool.cpu().numpy()


def frame_pool(traffic, size, generator, device):
    """The traffic's pool of distinct uint8 frames (``scenes``), drawn on
    the device and kept on the host; an open loop's pool repeats its first
    ``max_batch`` frames past its end, so that every batch is a view of
    it."""
    pool = scenes(traffic['pool_frames'], size, generator, device)
    if traffic['loop'] == 'open':
        pool = torch.cat([pool, pool[:traffic['max_batch']]])
    return pool


def scenes(n, size, generator, device):
    """``n`` uint8 frames [n, size, size, 3] of ``SHAPES`` filled
    rectangles each, of random colours on a random plain background, sides
    ``SIDES`` of the frame, painted in turn, with a little noise
    (``NOISE``): large high-contrast shapes that move the seeded network's
    answer from frame to frame. Drawn from ``generator`` in a few calls."""
    def draw(*shape):
        return torch.rand(shape, generator=generator, device=device)
    colour = torch.randint(0, 256, (n, SHAPES + 1, 3), generator=generator,
                           device=device, dtype=torch.uint8)
    low, high = SIDES
    side = (low + (high - low) * draw(n, SHAPES, 2)) * size
    corner = draw(n, SHAPES, 2) * (size - side)
    lo, hi = corner.long(), (corner + side).long()
    axis = torch.arange(size, device=device)
    frames = colour[:, 0, None, None, :].expand(n, size, size, 3).clone()
    for k in range(SHAPES):
        rows = (axis >= lo[:, k, 0, None]) & (axis < hi[:, k, 0, None])
        cols = (axis >= lo[:, k, 1, None]) & (axis < hi[:, k, 1, None])
        inside = rows[:, :, None, None] & cols[:, None, :, None]
        frames = torch.where(inside, colour[:, k + 1, None, None, :],
                             frames)
    noise = torch.randint(-NOISE, NOISE + 1, (n, size, size, 3),
                          generator=generator, device=device,
                          dtype=torch.int16)
    return (frames.to(torch.int16) + noise).clamp_(0, 255).to(torch.uint8)


def camera_names(n):
    return ['cam{:03d}'.format(k) for k in range(n)]


def run(cell, seed, seconds, traced, device, started):
    """(result dict, stderr lines, record) of one run on ``device`` (a
    torch.device); ``started`` is the process's start on the host clock.
    The record is what the metric readers read."""
    program.load()
    cfg, traffic = cell.config, cell.traffic
    ref = cell.reference()
    cuda = device.type == 'cuda'
    phases = [('imports', time.perf_counter())]

    n_cams = traffic['cameras']
    max_batch = traffic['max_batch']
    leaves, host, pool = weights_and_frames(cell, seed, device)
    tree = plain.nested_numpy(host, leaves)
    rng = np.random.default_rng(seed)
    cameras = camera_names(n_cams)
    masked = set(cameras[::traffic['masked_every']])
    phases.append(('weights and frames', time.perf_counter()))
    min_batch = traffic.get('min_bucket', 1)
    backend = program.build(cfg, tree, device, cameras, masked, max_batch,
                            min_batch)
    del tree
    phases.append(('program built', time.perf_counter()))
    flops = plain.forward_flops(ref.forward, cfg)
    phases.append(('flops counted', time.perf_counter()))

    if traffic['loop'] == 'closed':
        warm = [bucket(n_cams)]
    else:
        low = bucket(min(min_batch, max_batch))
        warm = [b for b in BUCKETS if low <= b <= bucket(max_batch)]
    for b in warm:
        for _ in range(3):             # both pinned staging slots too
            backend.warmup(batch=b)
    tracer = trace.Slice(traffic['trace_seconds'] if traced else None,
                         device)
    if traced:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU] +
                     ([ProfilerActivity.CUDA] if cuda else [])):
            backend.warmup(batch=warm[-1])
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases.append(('warmed', time.perf_counter()))

    record = Record(traffic['check_frames'], rng)
    driver = Driver(backend, pool, record, tracer, cfg['max_detections'],
                    bucket)
    if traffic['loop'] == 'closed':
        batches = traffic['pool_frames'] // n_cams

        def batch(i):
            return (i % batches) * n_cams, n_cams, cameras
        start, end = driver.closed(batch, seconds)
    else:
        due, senders = schedule(traffic, seconds, rng)
        start, end = driver.open(due, senders, max_batch,
                                 traffic['gather_ms'] / 1e3, seconds)
    setup_s = start - started
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit('the run loaded {}'.format(', '.join(found)))

    del driver, backend
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers, extra = compare(cell, ref, (leaves, host), device, record, pool,
                             cameras, masked)
    reduced = tracer.reduce() if traced else None
    rec = {'config': cfg, 'traffic': traffic, 'seconds': seconds,
           'setup_s': setup_s, 'window': (start, end),
           'cut': tracer.start if tracer.state == 'done' else end,
           'batches': record.arrays(), 'due': np.asarray(record.due),
           'done': np.asarray(record.done), 'flops_per_frame': flops,
           'trace': reduced, 'readings': extra}
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m['name'])(rec)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    info = {'platform': 'gpu' if cuda else device.type,
            'kind': torch.cuda.get_device_name(device) if cuda
            else device.type,
            'count': 1, 'memory_peak_bytes': peak}
    result = {'correct': check.passed(numbers),
              'attempted': record.attempted, 'failed': record.failed,
              'metrics': metrics, 'device': info}
    if reduced is not None:
        start_ns, end_ns = reduced['window_ns']
        info['busy_s'] = stats.busy_us(reduced['device']) / 1e9
        info['window_s'] = (end_ns - start_ns) / 1e9
        result['breakdown'] = trace.breakdown(reduced)
    result['compared'] = numbers
    marks = [('start', started)] + phases + [('window', start)]
    lines = ['setup: ' + ', '.join('{} {:.2f} s'.format(
        name, t - marks[i][1]) for i, (name, t) in enumerate(marks[1:]))]
    lines += ['compared {}: {} (limit {})'.format(name, n['value'],
                                                  n['limit'])
              for name, n in numbers.items()]
    return result, lines, rec


def compare(cell, ref, weights, device, record, pool, cameras, masked):
    """The comparison of the kept sample with the reference, on the
    run's ``weights`` = (leaves, flat host tree) copied to the device, in
    f32 with TF32 off."""
    cfg = cell.config
    leaves, host = weights
    weights = plain.Weights(plain.views(torch.from_numpy(host).to(device),
                                        leaves))
    kept = record.kept()
    frames = [item[0] for item in kept]
    inputs = pool[[item[1] for item in kept]]
    senders = [item[2] for item in kept]
    anchors = torch.from_numpy(ref.anchors(cfg)).to(device)
    columns = ref.label_columns(cfg, post.watched_labels(cfg))
    filters = post.camera_filters(cfg, cameras, masked)
    with no_tf32(), torch.no_grad():
        return check.compare(
            frames, senders, inputs,
            (lambda x: ref.forward(weights, x, cfg), anchors, columns,
             device), cfg, filters)


@contextlib.contextmanager
def no_tf32():
    """f32 products and convolutions in f32, not TF32, for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
