"""The port's counterparts of the repo's measurement scripts under
``scripts/``, each a subcommand of ``python -m watsor_tpu_torch.bench``:

- ``host_budget`` (scripts/host_budget.py): ``bench host``;
- ``nms_modes`` (measure_nms_modes.py, validate_nms_modes.py,
  measure_nms_active.py): ``bench nms``;
- ``int8_full`` (bench_int8_full.py): ``bench int8``;
- ``overlap`` (measure_overlap.py): ``bench overlap``;
- ``roofline_table`` (roofline.py, validate_timing.py): ``bench models``;
- ``overlay`` (measure_overlay.py): ``bench overlay``;
- ``warm_restart`` (warm_restart.py): ``bench restart``;
- ``lite4`` (profile_lite4.py, profile_lite4_sections.py,
  profile_backbone_stages.py): ``bench lite4``.

Each module's ``measure(device, ...)`` returns the script's record as a
dict, with the card's name and power limit under ``device``. A module
writes a file only where its script's environment variable names one.
"""

import contextlib
import json
import os
from time import perf_counter

import torch


def env_int(name, default):
    """The integer environment variable ``name``, or ``default`` where it is
    unset or empty."""
    return int(os.environ.get(name) or default)


@contextlib.contextmanager
def scoped_environ(values):
    """``values`` set in os.environ for a block (None removes one), then
    restored."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_out(name, row, mode):
    """The record into the file the environment variable ``name`` names,
    if it is set (``mode`` 'w' as run_baseline5.py, 'a' as
    latency_sweep.py)."""
    out = os.environ.get(name)
    if out:
        with open(out, mode) as f:
            f.write(json.dumps(row) + '\n')


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def dispatch_ms(step, buffers, steps, device):
    """The scripts' back-to-back dispatch loop: one warm call, then
    ``steps`` calls of ``step`` over ``buffers`` in turn and one
    synchronise. Returns ms a step (host launches included: an eager step
    on the card is bound by them)."""
    step(buffers[0])
    sync(device)
    t0 = perf_counter()
    for i in range(steps):
        step(buffers[i % len(buffers)])
    sync(device)
    return (perf_counter() - t0) / steps * 1000.0


def chained_ms(step, batch, size, device, n_short=2, n_long=32, log=None):
    """``chained_input_ms`` over ``step(frames)``, seeded uint8 frames of
    ``batch`` x ``size`` x ``size``."""
    from watsor_tpu_torch import timing
    return chained_input_ms(step, timing.seeded_frames(batch, (size, size),
                                                       device),
                            device, n_short=n_short, n_long=n_long, log=log)


def chained_input_ms(step, make_input, device, n_short=2, n_long=32,
                     log=None):
    """``timing.chained_step_ms`` over ``step(x)``, ``x`` made by
    ``make_input(generator)``: the step captured once as a CUDA graph and
    replayed (eager on the CPU). Returns (ms a step, detail)."""
    from watsor_tpu_torch import timing
    return timing.chained_step_ms(
        timing.chained_input_runner(step, make_input, device=device),
        n_short=n_short, n_long=n_long, log=log)
