"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, its cells cut to a size a test can hold, and a run of
a cell on the CPU."""

import json
import os
import shutil
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def copy_benchmark(directory):
    """BENCHMARK.json and benchmark/ copied under ``directory``."""
    shutil.copytree(os.path.join(REPO, 'benchmark'),
                    os.path.join(directory, 'benchmark'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), directory)
    return str(directory)


def cell(name, root=REPO):
    """The cell ``name`` of the checkout at ``root``."""
    from benchmark.lib import spec
    return spec.Cell(spec.load(root), name, root)


def tiny(cell, size=None, **traffic):
    """``cell`` cut to run on the CPU in seconds: its model at ``size``
    (256 if None: at 128 the pyramid's coarse anchors outgrow the frame
    and bf16 rounding moves their boxes as far as the control does), 8 cameras, a small pool."""
    cfg = cell.config
    cfg['input_size'] = size or 256
    cfg['anchors'] = len(cell.reference().anchors(cfg))
    changes = dict(cameras=min(cell.traffic['cameras'], 8), max_batch=8,
                   pool_frames=24, check_frames=16, trace_seconds=0.5)
    if cell.traffic['loop'] == 'open':
        changes['fps'] = 5
    changes.update(traffic)
    cell.traffic.update(changes)
    return cell


def run_cpu(cell, seed=7, seconds=1.0, traced=False):
    from benchmark.lib import cell as runner
    return runner.run(cell, seed, seconds, traced, torch.device('cpu'),
                      time.perf_counter())


def write_json(path, value):
    with open(path, 'w') as f:
        json.dump(value, f, indent=1)
