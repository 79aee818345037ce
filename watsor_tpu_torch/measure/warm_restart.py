"""A process's time to its first detection, cold and after a restart with
the kernel build directory kept (counterpart of scripts/warm_restart.py).

Two child processes share one new, empty ``WATSOR_KERNEL_CACHE_DIR``
(watsor_tpu_torch/_build.py). Each builds the serving detector as
``python -m watsor_tpu_torch.warmup`` does: ``build_from_zoo`` of
``MODEL`` (the zoo's default model, ``nms: fused``, seeded weights) on the
device (``model_build_s``), then the four kernel libraries
(``warmup.build_kernels``: one nvcc each, all at once, or found built) and
one detect step of ``BATCH`` (32) zero frames
(``first_step_s``, which holds the kernel build, ``kernel_build_s``, and
cuDNN's first-call set-up, which no process keeps for the next).

  leg "cold"     the empty directory: every kernel is built
  leg "restart"  the same directory: every kernel is found built

The parent makes no CUDA call: each child meets the card fresh, as a
restarted service does. A child that fails fails the measurement. On the
CPU no kernel is built. The record is appended to ``WARM_RESTART_OUT``
where that is set (the script appends to the repo's WARM_RESTART.jsonl;
this module never does). The directory is removed afterwards.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from time import perf_counter

from watsor_tpu_torch.measure import write_out

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LEG_TIMEOUT_S = 900
MODEL = ''          # the zoo's default
BATCH = 32

CHILD = r"""
import json, sys
from time import perf_counter
sys.path.insert(0, {root!r})
import torch
from watsor_tpu_torch.models.zoo import DEFAULT_MODEL, build_from_zoo
from watsor_tpu_torch.warmup import build_kernels
from watsor_tpu_torch.workload import card_label
device = torch.device({device!r})
t0 = perf_counter()
det = build_from_zoo({model!r} or DEFAULT_MODEL, None, device=device)
build_s = perf_counter() - t0
size = det.config.input_size
frames = torch.zeros(({batch}, size, size, 3), dtype=torch.uint8,
                     device=device)
t0 = perf_counter()
kernels = build_kernels() if device.type == 'cuda' else {{}}
kernel_s = perf_counter() - t0
det.detect_batch(frames).valid.cpu()
print('RESULT ' + json.dumps({{
    'build_s': build_s, 'kernel_s': kernel_s,
    'first_s': perf_counter() - t0, 'kernels': kernels,
    'device': card_label(device)}}), flush=True)
"""


def run_leg(cache_dir, device, model, batch):
    code = CHILD.format(root=ROOT, device=str(device), model=model,
                        batch=batch)
    env = dict(os.environ, WATSOR_KERNEL_CACHE_DIR=cache_dir)
    t0 = perf_counter()
    proc = subprocess.run([sys.executable, '-u', '-c', code], env=env,
                          capture_output=True, text=True,
                          timeout=LEG_TIMEOUT_S)
    wall = perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError('leg failed: %s' % proc.stderr[-2000:])
    for line in proc.stdout.splitlines():
        if line.startswith('RESULT '):
            got = json.loads(line[len('RESULT '):])
            return {'process_wall_s': round(wall, 1),
                    'model_build_s': round(got['build_s'], 1),
                    'first_step_s': round(got['first_s'], 1),
                    'kernel_build_s': round(got['kernel_s'], 1),
                    'kernels': got['kernels'], 'device': got['device']}
    raise RuntimeError('no RESULT line in: %s' % proc.stdout[-2000:])


# the formulas of scripts/warm_restart.py:413-415
def speedup_first_step(cold, warm):
    return round(cold['first_step_s'] / max(warm['first_step_s'], 1e-9), 1)


def cache_hit(cold, warm):
    return warm['first_step_s'] < 0.5 * cold['first_step_s']


def measure(device, log=None):
    batch, model = BATCH, MODEL
    cache_dir = tempfile.mkdtemp(prefix='watsor_warm_restart_')
    try:
        if log:
            log('warm_restart: cold leg (empty kernel build directory {})'
                .format(cache_dir))
        cold = run_leg(cache_dir, device, model, batch)
        n_entries = sum(len(files) for _, _, files in os.walk(cache_dir))
        if log:
            log('warm_restart: {} entries; restart leg'.format(n_entries))
        warm = run_leg(cache_dir, device, model, batch)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    label = cold.pop('device')
    warm.pop('device')
    record = {
        'metric': 'warm restart: first detection step wall time, cold '
                  'kernel build vs a process restart with the kernel '
                  'build directory kept',
        'model': model or 'zoo default', 'batch': batch,
        'platform': str(device),
        'cold': cold, 'restart': warm,
        'cache_entries': n_entries,
        'speedup_first_step': speedup_first_step(cold, warm),
        'cache_hit': cache_hit(cold, warm),
        'device': label,
    }
    write_out('WARM_RESTART_OUT', record, 'a')
    return record
