"""The detect step under each NMS mode and class count (counterpart of
scripts/measure_nms_modes.py, scripts/validate_nms_modes.py and
scripts/measure_nms_active.py).

``SSDConfig(nms_mode=m)`` (ssd_mobilenet_v2 at 300x300, bf16, seeded
weights) at ``BENCH_BATCH`` (32) frames, for each mode of ``MODES``
(``fused``, ``fused_exact``, ``exact``) and two class counts: all 90
(``active_labels=None``, tag ``C90``) and person and car (``(1, 3)``, tag
``C2_person_car``). Each (mode, classes) is timed twice:

- the scripts' back-to-back dispatch loop over ``BENCH_STEPS`` (30) steps,
  host launches included;
- the chained harness (``timing.chained_step_ms`` over
  ``timing.chained_model_runner``: the step captured once as a CUDA graph)
  with ``N_SHORT`` and ``N_LONG`` (2 and 32) steps, device time only.

The record is validate_nms_modes.py's (``batch``, ``harness``, ``probe``,
``modes``): ``modes[m]`` holds measure_nms_modes.py's line at C = 90
(``mode``, ``ms_per_step``, ``frames_per_s``) and validate_nms_modes.py's
chained row (``chained_ms_per_step``, ``fps`` and the harness's detail).
``active`` holds measure_nms_active.py's rows (``C90_fused``, ...: ``ms``,
``fps``) for every mode at both class counts, each with its chained time
(``chained_ms_per_step``, ``chained_fps``); its C90 rows are the numbers of
``modes``. ``fused_exact`` launches kernel 1 (csrc/nms_fixed_point.cu) at
[batch, C, 128], ``exact`` kernel 3 (csrc/nms_suppress.cu) at
[batch, C, 100]; ``fused`` launches none. The record goes to ``NMS_OUT``
where that is set (the scripts append to TIMING_VALIDATION.jsonl and
write under /tmp; this module does neither).
"""

import numpy as np

from watsor_tpu_torch.measure import (chained_ms, dispatch_ms, env_int,
                                      write_out)

INPUT_SIZE = 300
MODES = ('fused', 'fused_exact', 'exact')
CLASSES = ((None, 'C90'), ((1, 3), 'C2_person_car'))


def measure(device, log=None):
    import torch

    from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
    from watsor_tpu_torch.workload import card_label

    batch = env_int('BENCH_BATCH', 32)
    steps = env_int('BENCH_STEPS', 30)
    n_short = env_int('N_SHORT', 2)
    n_long = env_int('N_LONG', 32)
    rng = np.random.RandomState(0)
    buffers = [torch.from_numpy(rng.randint(
        0, 255, (batch, INPUT_SIZE, INPUT_SIZE, 3), np.uint8)).to(device)
        for _ in range(4)]
    record = {'batch': batch, 'harness': 'chained+fresh-seed',
              'probe': 'nms_modes_ssd300', 'modes': {}, 'active': {}}
    variables = None
    for labels, tag in CLASSES:
        for mode in MODES:
            detector = build_detector(
                SSDConfig(nms_mode=mode, active_labels=labels,
                          input_size=INPUT_SIZE),
                variables=variables, device=device)
            variables = detector.variables     # seed 0's tree for all
            ms = dispatch_ms(detector.detect_batch, buffers, steps, device)
            chained, detail = chained_ms(
                detector.detect_batch, batch, INPUT_SIZE, device,
                n_short=n_short, n_long=n_long)
            row = {'ms': round(ms, 2), 'fps': round(batch / ms * 1000.0, 1),
                   'chained_ms_per_step': round(chained, 2),
                   'chained_fps': round(batch * 1000.0 / chained, 1)}
            record['active']['{}_{}'.format(tag, mode)] = row
            if labels is None:
                record['modes'][mode] = dict(
                    {'mode': mode, 'ms_per_step': row['ms'],
                     'frames_per_s': row['fps'],
                     'chained_ms_per_step': row['chained_ms_per_step'],
                     'fps': row['chained_fps']}, **detail)
            if log:
                log('{}_{} {}'.format(tag, mode, row))
    record['device'] = card_label(device)
    write_out('NMS_OUT', record, 'w')
    return record
