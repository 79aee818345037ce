"""The roofline row and the chained step time of every zoo model
(counterpart of scripts/roofline.py and scripts/validate_timing.py).

For each model (the names given, else all nine of the zoo, as
roofline.py), ``build_from_zoo(name)`` (the
zoo's bf16 detector, ``nms: fused``, seeded weights) at ``BENCH_BATCH``
(32) frames of its input size:

- ``ms_per_step``: roofline.py's back-to-back dispatch loop over
  ``BENCH_STEPS`` (20) steps, host launches included;
- ``chained_ms_per_step``: validate_timing.py's chained harness with
  ``N_SHORT`` and ``N_LONG`` (2 and 32) steps, the step captured once as a
  CUDA graph (device time only);
- ``roofline.step_cost`` (FlopCounterMode's FLOPs and the byte floor) over
  one call of the step. The zoo detector is the plain walk and ``nms:
  fused`` launches no hand-written kernel, so nothing escapes the counter
  (it cannot see a ctypes launch); ``flops_source`` says so;
- ``roofline.roofline_row`` at the dispatch loop's time.

``WATSOR_FUSED_HEADS`` goes into ``knobs`` as validate_timing.py records
it; its ``WATSOR_UPSAMPLE`` has no counterpart in the port. Each model's
roofline row is appended to ``ROOFLINE_OUT`` and its chained row to
``VALIDATE_OUT`` where those are set (the scripts append to the repo's
ROOFLINE.jsonl and TIMING_VALIDATION.jsonl; this module never does).
"""

import os

import numpy as np

from watsor_tpu_torch.measure import (chained_ms, dispatch_ms, env_int,
                                      write_out)

ALL = ('ssd_mobilenet_v1', 'ssd_mobilenet_v2', 'ssdlite_mobilenet_v2',
       'ssd_inception_v2', 'efficientdet_lite0', 'efficientdet_lite1',
       'efficientdet_lite2', 'efficientdet_lite3', 'efficientdet_lite4')
FLOPS_SOURCE = ('torch.utils.flop_counter.FlopCounterMode over one call of '
                'the plain walk (the zoo detector; nms fused launches no '
                'hand-written kernel)')


def measure_model(name, device, batch, steps, n_short, n_long):
    """One model's roofline row with its chained time beside it."""
    import torch

    from watsor_tpu_torch import roofline
    from watsor_tpu_torch.models.zoo import build_from_zoo
    from watsor_tpu_torch.workload import card_label

    detector = build_from_zoo(name, None, device=device)
    size = detector.config.input_size
    rng = np.random.RandomState(0)
    buffers = [torch.from_numpy(rng.randint(
        0, 255, (batch, size, size, 3), np.uint8)).to(device)
        for _ in range(2)]
    step = detector.detect_batch
    ms = dispatch_ms(step, buffers, steps, device)
    chained, detail = chained_ms(step, batch, size, device,
                                 n_short=n_short, n_long=n_long)
    flops, nbytes = roofline.step_cost(
        step, buffers[0], params=list(detector.model.state_dict().values()))
    row = roofline.roofline_row(name, batch, ms, flops, nbytes, device)
    row['device'] = card_label(device)
    row['flops_source'] = FLOPS_SOURCE
    chained_row = {'chained_ms_per_step': round(chained, 2),
                   'fps': round(batch * 1000.0 / chained, 1)}
    knobs = {k: os.environ[k] for k in ('WATSOR_FUSED_HEADS',)
             if os.environ.get(k)}
    if knobs:
        chained_row['knobs'] = knobs
    chained_row.update(detail)
    return row, chained_row


def measure(device, names=None, log=None):
    """validate_timing.py's record, each model's row also roofline.py's."""
    from watsor_tpu_torch.workload import card_label

    batch = env_int('BENCH_BATCH', 32)
    steps = env_int('BENCH_STEPS', 20)
    n_short = env_int('N_SHORT', 2)
    n_long = env_int('N_LONG', 32)
    results = {'batch': batch, 'n_short': n_short, 'n_long': n_long,
               'harness': 'chained+fresh-seed', 'models': {}}
    for name in names or ALL:
        row, chained_row = measure_model(name, device, batch, steps,
                                         n_short, n_long)
        results['models'][name] = dict(row, **chained_row)
        if log:
            log('{} {}'.format(name, results['models'][name]))
        write_out('ROOFLINE_OUT', row, 'a')
        write_out('VALIDATE_OUT', dict({'batch': batch,
                                        'harness': 'chained+fresh-seed',
                                        'model': name}, **chained_row), 'a')
    results['device'] = card_label(device)
    return results
