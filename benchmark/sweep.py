"""The sweep that fixes a live cell's camera count, in one process on the
card:

    python3 -m benchmark.sweep --workload NAME --cameras N ... \
        [--seconds 10] [--seed S]

Runs the cell's open-loop traffic at each camera count, one run each, and
prints one JSON line a count: the frames/s offered and served, the
latency's median and 95th percentile, and the backlog (frames due and not
yet dispatched, read at each dispatch) over the first and the last third
of the window. The knee is the highest count whose backlog does not grow;
the cell runs at 0.8 of it, rounded down to whole cameras.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from benchmark.run import ROOT, environment


def row(cameras, fps, rec):
    start, end = rec['window']
    table = rec['batches']
    t = table['dispatch0'] - start
    seconds = rec['seconds']
    first = table['backlog'][t < seconds / 3]
    last = table['backlog'][(t >= 2 * seconds / 3) & (t < seconds)]
    latency = (rec['done'] - rec['due']) * 1e3
    return {'cameras': cameras, 'offered_fps': cameras * fps,
            'served_fps': float(table['frames'].sum() / (end - start)),
            'p50_ms': float(np.percentile(latency, 50)),
            'p95_ms': float(np.percentile(latency, 95)),
            'batch_frames': float(table['frames'].mean()),
            'backlog_first': float(first.mean()) if len(first) else None,
            'backlog_last': float(last.mean()) if len(last) else None,
            'backlog_max': float(table['backlog'].max())}


def main(argv=None):
    parser = argparse.ArgumentParser(prog='python3 -m benchmark.sweep')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--cameras', type=int, nargs='+', required=True)
    parser.add_argument('--seconds', type=float, default=10.0)
    parser.add_argument('--seed', type=int, default=1)
    args = parser.parse_args(argv)
    environment(ROOT)
    import torch
    from benchmark.lib import cell as runner
    from benchmark.lib import spec
    if not torch.cuda.is_available():
        print('benchmark.sweep: no CUDA device', file=sys.stderr)
        return 2
    cell = spec.Cell(spec.load(ROOT), args.workload, ROOT)
    for cameras in args.cameras:
        cell.traffic['cameras'] = cameras
        result, _, rec = runner.run(cell, args.seed, args.seconds, False,
                                    torch.device('cuda', 0),
                                    time.perf_counter())
        out = row(cameras, cell.traffic['fps'], rec)
        out['correct'] = result['correct']
        print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    os.chdir(ROOT)
    sys.exit(main())
