"""Transfer against compute in the backend's pipeline (counterpart of
scripts/measure_overlap.py).

``SSDConfig()`` (ssd_mobilenet_v2 at 300x300, bf16, ``nms: fused``,
seeded weights) behind a ``TorchDetectorBackend``, for each batch of
``BATCHES`` (4, 8, 16, 32), over three host batches of ``default_rng(0)``:

1. ``h2d_ms``: the transfer the backend makes, alone: the batch copied
   into its pinned staging buffer and sent ``non_blocking`` on the
   backend's stream, then a synchronise (a plain ``.to(device)`` from
   pageable memory would be synchronous and hide nothing);
2. ``step_ms``: the step the backend runs (``detection/backend._step``:
   detect, then pack) on inputs already on the device, dispatched back to
   back on the backend's stream;
3. ``pipelined_ms``: ``TorchDetectorBackend.dispatch``/``resolve`` with two
   batches in flight, a fresh copy from the host each step (the detector
   task's pattern; the resolve adds the packed result's one D2H copy and
   the host's unpacking).

Each is the median of ``REPS`` (9) loops of ``BENCH_STEPS`` (12)
steps, the three loops taken in turn: one loop on a shared host is noisy.
``overlap_fraction`` is (h2d + step - pipelined) / min(h2d, step): 1 when
the transfer hides behind the step, 0 when they run one after the other;
the pipelined step does more host work than the two alone, so it can read
below 0. A
least-squares fit ``pipelined = a + b * batch`` splits the fixed cost a
step from the marginal cost a frame. The record goes to
``OVERLAP_RESULTS`` where that is set (the script writes
/tmp/overlap_results.json by default).
"""

import contextlib
from time import perf_counter

import numpy as np

from watsor_tpu_torch.measure import env_int, sync, write_out

BATCHES = (4, 8, 16, 32)
REPS = 9


# the formulas of scripts/measure_overlap.py:85-86 and :99-109
def overlap_fraction(t_h2d, t_step, t_pipe):
    denom = min(t_h2d, t_step)
    return (t_h2d + t_step - t_pipe) / denom if denom > 0 else 0.0


def fixed_marginal_split(rows):
    """(fixed ms a step, marginal ms a frame, the frames/s of the marginal
    cost alone or None) of the least-squares line through the rows'
    (batch, pipelined_ms)."""
    bs = np.array([r['batch'] for r in rows], np.float64)
    ts = np.array([r['pipelined_ms'] for r in rows], np.float64)
    b_slope, a_fixed = np.polyfit(bs, ts, 1)
    return (float(a_fixed), float(b_slope),
            1000.0 / b_slope if b_slope > 0 else None)


def backend_stream(backend):
    """The backend's CUDA stream as a context (none on the CPU)."""
    import torch
    return torch.cuda.stream(backend._stream) if backend._cuda \
        else contextlib.nullcontext()


def backend_h2d(backend, images):
    """The copy ``TorchDetectorBackend.dispatch`` makes of ``images``
    (detection/backend.py: pinned staging, ``non_blocking`` on the
    backend's stream), finished; returns the device tensor."""
    from watsor_tpu_torch.detection.backend import recorded
    host, copies = backend._staging.fill(images, images.shape)
    with backend_stream(backend):
        x = host.to(backend._device, non_blocking=True)
        if backend._cuda:
            copies.append(recorded(backend._stream))
            backend._stream.synchronize()
    return x


def measure(device, batches=None, log=None):
    import torch

    from watsor_tpu_torch.detection.backend import (TorchDetectorBackend,
                                                    _step)
    from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
    from watsor_tpu_torch.workload import card_label

    batches = tuple(batches or BATCHES)
    steps = env_int('BENCH_STEPS', 12)
    det = build_detector(SSDConfig(), device=device)
    size = det.config.input_size
    backend = TorchDetectorBackend(det, device, max_batch=max(batches))
    rng = np.random.default_rng(0)

    rows = []
    for B in batches:
        host = [rng.integers(0, 255, (B, size, size, 3), np.uint8)
                for _ in range(3)]
        backend.detect_batch(host[0])          # warm the (B, size) step

        def h2d_loop():
            for i in range(steps):
                backend_h2d(backend, host[i % 3])

        staged = [torch.from_numpy(h).to(device) for h in host]
        sync(device)

        def step_loop():
            with backend_stream(backend), torch.inference_mode():
                for i in range(steps):
                    _step(det, staged[i % 3], None, None)
            sync(device)

        def pipelined_loop():
            inflight = []
            for i in range(steps):
                inflight.append(backend.dispatch(host[i % 3]))
                if len(inflight) > 1:
                    backend.resolve(inflight.pop(0))
            while inflight:
                backend.resolve(inflight.pop(0))

        # the three loops in turn, REPS times, so that a slow spell of the
        # shared host falls on all three alike
        times = np.zeros((REPS, 3))
        for rep in range(REPS):
            for j, loop in enumerate((h2d_loop, step_loop, pipelined_loop)):
                t = perf_counter()
                loop()
                times[rep, j] = (perf_counter() - t) / steps
        t_h2d, t_step, t_pipe = (float(v) for v in np.median(times, axis=0))

        overlap = overlap_fraction(t_h2d, t_step, t_pipe)
        rows.append({'batch': B,
                     'h2d_ms': round(t_h2d * 1e3, 2),
                     'step_ms': round(t_step * 1e3, 2),
                     'pipelined_ms': round(t_pipe * 1e3, 2),
                     'overlap_fraction': round(overlap, 3),
                     'pipelined_fps': round(B / t_pipe, 1)})
        if log:
            log('batch {}: h2d {:.2f} ms step {:.2f} ms pipe {:.2f} ms '
                'overlap {:.2f}'.format(B, t_h2d * 1e3, t_step * 1e3,
                                        t_pipe * 1e3, overlap))

    fixed, marginal, corrected = fixed_marginal_split(rows)
    record = {
        'metric': 'transfer/compute overlap, SSD300 fused step',
        'rows': rows,
        'fixed_cost_ms': round(fixed, 2),
        'marginal_ms_per_frame': round(marginal, 4),
        'fixed_cost_corrected_fps': round(corrected, 1)
        if corrected is not None else None,
        'device': card_label(device),
    }
    write_out('OVERLAP_RESULTS', record, 'w')
    return record
