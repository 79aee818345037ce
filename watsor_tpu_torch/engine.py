"""Drop-in shim for the reference's engine-build CLI (counterpart of
watsor_tpu/engine.py).

The reference builds its TensorRT engine offline with
``python -m watsor.engine -i gpu.uff -o gpu.trt -p 16``
(upstream watsor, engine.py:73-107). The port's analog is the
build-ahead of :mod:`watsor_tpu_torch.warmup`: its CUDA kernels built into
the kernel build directory, then the detection step run once a bucket.
This shim keeps scripts written against the reference CLI working: the
familiar flags are accepted, ``-i``'s model file stem selects the zoo
model when it matches, ``-o``'s directory becomes the kernel build
directory, and the precision flag carries through.
"""

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Utility to build the detection model prior to '
                    'inference (reference engine.py compatibility; the '
                    '"engine" is the built CUDA kernels)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-i', '--input', dest='model_path',
                        metavar='MODEL_PATH',
                        help='model file or zoo name (the UFF/ONNX inputs '
                             'of the reference map to zoo models here)')
    parser.add_argument('-p', '--precision', type=int, choices=[32, 16],
                        default=16, help='float precision (16 = bfloat16)')
    parser.add_argument('-w', '--workspace', default=1024, type=int,
                        help='ignored (PyTorch manages device memory)')
    parser.add_argument('-mw', '--model-width', type=int, default=300,
                        help='ignored (model input size comes from the zoo)')
    parser.add_argument('-mh', '--model-height', type=int, default=300,
                        help='ignored (model input size comes from the zoo)')
    parser.add_argument('-o', '--output', dest='engine_path',
                        default=os.environ.get('WATSOR_KERNEL_CACHE_DIR'),
                        help='kernel build directory (a file path uses its '
                             'parent; default build/watsor_tpu_torch/)')
    args = parser.parse_args(argv)

    from watsor_tpu_torch.models.zoo import MODEL_REGISTRY
    from watsor_tpu_torch import warmup

    warmup_args = ['-p', str(args.precision)]
    cache_dir = args.engine_path
    if cache_dir:
        if os.path.splitext(cache_dir)[1]:        # looked like a file path
            cache_dir = os.path.dirname(cache_dir) or '.'
        warmup_args += ['--cache-dir', cache_dir]
    if args.model_path:
        stem = os.path.splitext(os.path.basename(args.model_path))[0]
        if stem in MODEL_REGISTRY:
            warmup_args += ['-m', stem]
        else:
            # a weight-file path: its directory is the model dir
            warmup_args += ['--model-path',
                            os.path.dirname(os.path.abspath(
                                args.model_path))]
    print('Building the CUDA kernels into {} and running the detection '
          'step (the analog of the TensorRT engine build).'.format(
              cache_dir or 'the default kernel build directory'))
    warmup.main(warmup_args)


if __name__ == '__main__':
    sys.exit(main())
