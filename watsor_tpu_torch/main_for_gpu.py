"""Launcher that builds ahead of serving, then runs the application
(counterpart of watsor_tpu/main_for_tpu.py, under the reference's own
launcher name).

Drop-in parity with the reference's GPU launcher
(upstream watsor, main_for_gpu.py: build the TRT engine if missing,
then run): here the build is the port's warmup (watsor_tpu_torch/warmup.py)
for the configured model's batch buckets: the CUDA kernels built into the
kernel build directory (found there when an earlier process built them),
then the serving detector run once a bucket. A failed warmup is logged and
the service goes on: it then builds its kernels, or fails, at first use
as it would have.

    python -m watsor_tpu_torch.main_for_gpu --config config.yaml [...]
"""

import logging
import sys

_LOGGER = logging.getLogger(__name__)


def main(argv=None):
    from watsor_tpu_torch import main as app_main
    from watsor_tpu_torch import warmup

    args = app_main._parse_commandline_arguments(argv)
    # run the EXACT serving detector: the config's watched labels and NMS
    # mode, the model override
    warmup_args = ['-c', args.config]
    if args.model:
        warmup_args += ['-m', args.model]
    if args.model_path:
        warmup_args += ['--model-path', args.model_path]
    try:
        warmup.main(warmup_args)
    except Exception:
        _LOGGER.exception('Warmup failed; continuing (the kernels build on '
                          'the serving path)')
    app_main.TorchApplication(args).run()


if __name__ == '__main__':
    sys.exit(main())
