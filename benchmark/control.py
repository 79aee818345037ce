"""The readings the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 -m benchmark.control --workload NAME --seeds S ... \
        --control-seeds S ... [--faults] [--fault-seeds S ...] [--seconds 3]

Each program seed runs the cell's timed path for a short window at the
cell's own load and compares as a run does (the lower readings); each
control seed compares the reference computed in float8 e4m3 in the
program's place (the upper readings); with ``--faults`` each planted fault
runs on each fault seed. One JSON line a reading, then one with the
largest program reading and the smallest control reading of each number.
"""

import argparse
import json
import os
import sys

from benchmark.run import ROOT, environment


def main(argv=None):
    parser = argparse.ArgumentParser(prog='python3 -m benchmark.control')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
    parser.add_argument('--faults', action='store_true')
    parser.add_argument('--fault-seeds', type=int, nargs='*', default=[])
    parser.add_argument('--seconds', type=float, default=3.0)
    args = parser.parse_args(argv)
    environment(ROOT)
    import torch
    from benchmark.lib import control, faults, spec
    if not torch.cuda.is_available():
        print('benchmark.control: no CUDA device', file=sys.stderr)
        return 2
    cell = spec.Cell(spec.load(ROOT), args.workload, ROOT)
    rows = []
    for row in control.readings(
            cell, args.seeds, args.control_seeds, args.seconds,
            torch.device('cuda', 0),
            faults=sorted(faults.FAULTS) if args.faults else (),
            fault_seeds=args.fault_seeds):
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {'workload': args.workload}
    names = [k for k in rows[0] if k not in ('kind', 'seed')]
    for name in names:
        program = [r[name] for r in rows if r['kind'] == 'program']
        ctrl = [r[name] for r in rows if r['kind'] == 'control']
        summary[name] = {'lower': max(program),
                         'upper': min(ctrl) if ctrl else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    os.chdir(ROOT)
    sys.exit(main())
