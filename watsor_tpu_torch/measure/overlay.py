"""The batched box overlay's frames/s (counterpart of
scripts/measure_overlay.py).

``ops/overlay.render_detections`` (the COCO colours, the renderer of
WATSOR_DEVICE_RENDER) over ``batch`` seeded frames of ``h`` x ``w`` on the
device, each with 8 boxes of its 100 slots: one warm call, then 20 calls
back to back and one synchronise. No hand-written kernel runs here.
"""

from time import perf_counter

import numpy as np

from watsor_tpu_torch.measure import sync

STEPS = 20
N_BOXES = 8


def overlay_inputs(batch, h, w, device):
    """(images, boxes in pixels, classes) as scripts/measure_overlay.py:
    118-130 makes them, on ``device``."""
    import torch

    from watsor_tpu_torch.runtime.frames import MAX_DETECTIONS
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randint(0, 255, (batch, h, w, 3), np.uint8)).to(device)
    boxes = np.zeros((batch, MAX_DETECTIONS, 4), np.float32)
    classes = np.zeros((batch, MAX_DETECTIONS), np.int32)
    boxes[:, :N_BOXES] = rng.uniform(0, 1, (batch, N_BOXES, 4))
    boxes[:, :N_BOXES, 2:] = boxes[:, :N_BOXES, :2] + 0.2
    boxes[:, :N_BOXES] *= np.array([h, w, h, w], np.float32)
    classes[:, :N_BOXES] = rng.randint(1, 10, (batch, N_BOXES))
    return (images, torch.from_numpy(boxes).to(device),
            torch.from_numpy(classes).to(device))


def measure(device, batch=16, h=1080, w=1920, log=None):
    from watsor_tpu_torch.ops.overlay import render_detections
    from watsor_tpu_torch.workload import card_label

    images, boxes, classes = overlay_inputs(batch, h, w, device)
    t0 = perf_counter()
    render_detections(images, boxes, classes)
    sync(device)
    if log:
        log('overlay b{} {}x{}: first call {:.1f} s'.format(
            batch, h, w, perf_counter() - t0))
    t0 = perf_counter()
    for _ in range(STEPS):
        render_detections(images, boxes, classes)
    sync(device)
    elapsed = perf_counter() - t0
    return {
        'kernel': 'device overlay render',
        'batch': batch, 'resolution': '{}x{}'.format(w, h),
        'ms_per_step': round(elapsed / STEPS * 1000.0, 2),
        'frames_per_s': round(batch * STEPS / elapsed, 1),
        'device': card_label(device),
    }
