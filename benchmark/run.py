"""Run one cell of the benchmark of watsor_tpu_torch on the card:

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints the result as the last line of
standard output (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics), and each number compared for
``correct`` beside its limit as the last lines of standard error. Exits
with 2, printing no result, without a CUDA device or with fewer than the
cell asks for.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    parser = argparse.ArgumentParser(prog='python3 -m benchmark.run',
                                     description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seconds <= 0:
        parser.error('--seconds must be above 0')
    return args


def environment(root):
    """The program's caches at fixed directories inside the checkout, and
    no setting of the program's own taken from the caller."""
    for key in [k for k in os.environ if k.startswith('WATSOR_')]:
        del os.environ[key]
    build = os.path.join(root, 'build')
    os.environ['WATSOR_KERNEL_CACHE_DIR'] = os.path.join(build,
                                                         'watsor_tpu_torch')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(build,
                                                      'torch_extensions')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(build, 'cuda_cache')


def main(argv=None):
    args = parse(argv)
    environment(ROOT)
    from benchmark.lib import spec
    cell = spec.Cell(spec.load(ROOT), args.workload, ROOT)

    import torch
    chips = cell.workload['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('benchmark: the cell needs {} CUDA device(s); {} visible'
              .format(chips, torch.cuda.device_count()
                      if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    from benchmark.lib import cell as runner
    result, lines, _ = runner.run(cell, args.seed, args.seconds,
                               bool(args.trace), torch.device('cuda', 0),
                               STARTED)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == '__main__':
    sys.exit(main())
