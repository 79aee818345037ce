"""watsor-tpu-torch: the detection main path of watsor-tpu in PyTorch for
one NVIDIA H100.

This package sits beside ``watsor_tpu`` (the JAX reference) and keeps its
own copy of the JAX package's host layers: configuration, the frame
runtime, the host filters, the video I/O with its native libav library
(``native/``, built with ``make`` at first use), the outputs and the
composition root (``main.py``). What touches the device is reimplemented
here with PyTorch modules, and each Pallas kernel has a hand-written CUDA
C++ counterpart under ``csrc/`` that is compiled for ``sm_90a`` at first
use (``_build.py``).

The package never imports ``jax`` nor anything of ``watsor_tpu``.
"""

__version__ = "0.1.0"
