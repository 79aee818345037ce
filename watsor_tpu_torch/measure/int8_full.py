"""The int8-activation step against the bf16 step, by pointwise
formulation (counterpart of scripts/bench_int8_full.py).

The bf16 ``SSDConfig()`` step first (ssd_mobilenet_v2 at 300x300, 90
classes, ``nms: fused``, seeded weights), then ``int8_full``
(``models/ssd_int8.build_int8_detector``) under ``WATSOR_INT8_POINTWISE``
set to each mode of ``MODES`` (``conv``, ``dot``, ``pallas``), calibrated
on the same 8 frames of ``default_rng(0)``. ``dot`` is XLA's dot_general
in the JAX package; the port has no such formulation and runs the
``conv`` walk under that name (models/ssd_int8.py), so its row times the
``conv`` walk a second time. Each step is timed by the script's
back-to-back loop (``BENCH_STEPS``, 20, over three batches of
``BENCH_BATCH``, 32, host launches included), and its scores on the first
batch are held to the bf16 step's by cosine (the script's acceptance bar:
0.95; with seeded random weights every kept score is near the same value,
so this cosine reads about 1 whatever the int8 walk computes: ``built``
hands a caller each mode's detector to hold its raw outputs). ``pallas``
launches kernel 4 (csrc/int8_matmul.cu), 38 times a forward. A mode that
raises fails the measurement: the script's per-mode error rows
(``bench_int8_full.py:81-83``) are not copied. The record goes to
``INT8_FULL_OUT`` where that is set (the script writes under /tmp).
"""

import numpy as np

from watsor_tpu_torch.measure import (dispatch_ms, env_int, scoped_environ,
                                      write_out)

INPUT_SIZE = 300
MODES = ('conv', 'dot', 'pallas')


# copied from scripts/bench_int8_full.py:37-41
def _cosine(a, b):
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return float(np.dot(a, b) /
                 (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def measure(device, log=None, built=None):
    """bench_int8_full.py's record; ``built(mode, qdetector)``, where
    given, receives each mode's int8 detector after its timing."""
    import torch

    from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
    from watsor_tpu_torch.models.ssd_int8 import build_int8_detector
    from watsor_tpu_torch.workload import card_label

    batch = env_int('BENCH_BATCH', 32)
    steps = env_int('BENCH_STEPS', 20)
    size = INPUT_SIZE
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 255, (8, size, size, 3), np.uint8)
    frames = [torch.from_numpy(rng.integers(0, 255, (batch, size, size, 3),
                                            np.uint8)).to(device)
              for _ in range(3)]

    det = build_detector(SSDConfig(input_size=size), device=device)
    bf16_ms = dispatch_ms(det.detect_batch, frames, steps, device)
    ref_scores = det.detect_batch(frames[0]).scores.cpu().numpy()
    results = {'bf16_ms': round(bf16_ms, 2),
               'bf16_fps': round(batch / bf16_ms * 1000.0, 1)}
    if log:
        log('bf16 {} ms'.format(results['bf16_ms']))
    for mode in MODES:
        with scoped_environ({'WATSOR_INT8_POINTWISE': mode}):
            qdet = build_int8_detector(det, calib)
        ms = dispatch_ms(qdet.detect_batch, frames, steps, device)
        q_scores = qdet.detect_batch(frames[0]).scores.cpu().numpy()
        results[mode] = {'mode': mode, 'ms': round(ms, 2),
                         'fps': round(batch / ms * 1000.0, 1),
                         'vs_bf16': round(bf16_ms / ms, 3),
                         'scores_cosine_vs_bf16': round(
                             _cosine(ref_scores, q_scores), 4)}
        if log:
            log('int8_full {}'.format(results[mode]))
        if built:
            built(mode, qdet)
    results['device'] = card_label(device)
    write_out('INT8_FULL_OUT', results, 'w')
    return results
