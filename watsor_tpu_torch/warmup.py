"""Build-ahead CLI: build the port's CUDA kernels and run the serving
detector once a batch bucket (counterpart of watsor_tpu/warmup.py).

The reference builds its TensorRT engine offline
(upstream watsor, engine.py, main_for_gpu.py:17-26); the JAX package
warms XLA's compilation cache. The port's ahead-of-time work is the build
of its four hand-written kernels: one ``nvcc`` a kernel, all started
together, into the kernel build directory (``--cache-dir``, by default
WATSOR_KERNEL_CACHE_DIR or ``build/watsor_tpu_torch/``). The built ``.so``
files persist across processes: a later process, the service's included,
loads them without building. Then the serving detector (the service's own
builder: the model, its watched labels and NMS mode from ``-c``, and the
WATSOR_* knobs) runs its step once a bucket on the card, and the seconds
of each are printed. cuDNN's per-shape set-up that the first step of a
bucket pays does not persist: each new process pays it again.

    python -m watsor_tpu_torch.warmup [-m MODEL] [-c CONFIG]
                                      [--model-path DIR] [--cache-dir DIR]
                                      [-b 1 2 4 8 16 32 64] [-p {32,16}]

Precision: ``-p 16`` (bf16, the default) or ``-p 32``; the
``TRT_FLOAT_PRECISION`` env var is honored for drop-in compatibility. The
detector runs on the device pool's first device (the card; the CPU only
where WATSOR_DEVICE_POOL names it, and then no kernel is built).
"""

import argparse
import concurrent.futures
import os
from time import perf_counter

import torch


def build_kernels():
    """Build (or find built) the four kernel libraries, one ``nvcc`` each,
    all at once: {name: seconds, or None where the library was already
    built}. Raises if a build fails."""
    from watsor_tpu_torch import _build
    from watsor_tpu_torch.ops import (fused_block, int8_matmul,
                                      nms_fixed_point, nms_suppress)
    libraries = {'nms_fixed_point': nms_fixed_point._SIGNATURES,
                 'fused_block': fused_block._SIGNATURES,
                 'nms_suppress': nms_suppress._SIGNATURES,
                 'int8_matmul': int8_matmul._SIGNATURES}

    def build(name, signatures):
        found = os.path.exists(_build.library_path(name))
        start = perf_counter()
        _build.load(name, signatures)
        return None if found else perf_counter() - start

    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        futures = {name: pool.submit(build, name, signatures)
                   for name, signatures in libraries.items()}
        return {name: future.result() for name, future in futures.items()}


def serving_spec(args):
    """(config, buckets): the config to build the serving detector from
    (the file of ``-c``, else no camera) and the batch buckets to run, with
    ``-c`` trimmed to what its cameras can produce."""
    from watsor_tpu_torch.detection.backend import _bucket
    if not args.config:
        return {'cameras': []}, sorted(set(args.batches))
    from watsor_tpu_torch.config import normalize, parse, validate
    config = normalize(validate(parse(args.config)),
                       os.path.dirname(os.path.abspath(args.config)))
    # a camera can contribute more than one frame to a batch (its queue
    # quota releases on get() and the detector's gather window stays open
    # a few ms): 2x headroom over the camera count, rounded up to the
    # runtime's bucket sizes (watsor_tpu/warmup.py:67-80)
    need = _bucket(min(max(2 * len(config['cameras']), 1), max(args.batches)))
    return config, sorted({b for b in args.batches if b <= need} | {need})


def main(argv=None):
    parser = argparse.ArgumentParser(description='Build the CUDA kernels '
                                                 'and run the detection step '
                                                 'once a batch bucket')
    parser.add_argument('-m', '--model', default=None,
                        help='model name from the zoo (default flagship)')
    parser.add_argument('-c', '--config', default=None,
                        help='application YAML: run the EXACT serving '
                             'detector (watched labels + nms mode)')
    parser.add_argument('--model-path', default=os.environ.get('MODEL_PATH'),
                        help='directory with model weights')
    parser.add_argument('--cache-dir',
                        default=os.environ.get('WATSOR_KERNEL_CACHE_DIR'),
                        help='kernel build directory (default '
                             'build/watsor_tpu_torch/ beside the package)')
    parser.add_argument('-b', '--batches', type=int, nargs='+',
                        default=[1, 2, 4, 8, 16, 32, 64],
                        help='batch buckets to run (must cover the '
                             'serving max_batch, default 64)')
    parser.add_argument('-p', '--precision', type=int,
                        choices=(16, 32),
                        default=int(os.environ.get('TRT_FLOAT_PRECISION',
                                                   16)),
                        help='activation precision (16 = bfloat16)')
    args = parser.parse_args(argv)

    from watsor_tpu_torch import _build
    from watsor_tpu_torch.detection.detector import resolve_device_pool
    from watsor_tpu_torch.main import TorchApplication

    config, buckets = serving_spec(args)
    device = resolve_device_pool()[0]
    saved = os.environ.get('WATSOR_KERNEL_CACHE_DIR')
    if args.cache_dir:
        os.environ['WATSOR_KERNEL_CACHE_DIR'] = args.cache_dir
    try:
        if device.type == 'cuda':
            start = perf_counter()
            for name, seconds in build_kernels().items():
                print('kernel {}: {}'.format(
                    name, 'found built' if seconds is None
                    else 'built in {:.1f} s'.format(seconds)))
            print('kernels ready in {:.1f} s under {}'.format(
                perf_counter() - start, _build.build_dir()))
        else:
            print('device {}: the CUDA kernels are not built'.format(device))
        app = TorchApplication(argparse.Namespace(
            model=args.model, model_path=args.model_path))
        detector = app._detector_factory(
            config, precision=str(args.precision))(device)
        size = detector.config.input_size
        for batch in buckets:
            frames = torch.zeros((batch, size, size, 3), dtype=torch.uint8,
                                 device=device)
            start = perf_counter()
            out = detector.detect_batch(frames)
            out.valid.cpu()
            print('batch {:3d}: ran in {:6.1f} s'.format(
                batch, perf_counter() - start))
    finally:
        if saved is None:
            os.environ.pop('WATSOR_KERNEL_CACHE_DIR', None)
        else:
            os.environ['WATSOR_KERNEL_CACHE_DIR'] = saved
    if device.type == 'cuda':
        print('The kernel libraries persist under {} for later processes; '
              "cuDNN's per-shape set-up does not".format(
                  args.cache_dir or _build.build_dir()))


if __name__ == '__main__':
    main()
