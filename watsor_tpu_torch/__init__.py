"""watsor-tpu-torch: the detection main path of watsor-tpu in PyTorch for
one NVIDIA H100.

This package sits beside ``watsor_tpu`` (the JAX reference) and reuses its
JAX-free host layers as they are: configuration, the frame runtime, the
host filters, the outputs and the ``Application`` composition root. What
touches the device is reimplemented here with PyTorch modules, and each
Pallas kernel on the main path has a hand-written CUDA C++ counterpart
under ``csrc/`` that is compiled for ``sm_90a`` at first use
(``_build.py``).

The package never imports ``jax``.
"""

__version__ = "0.1.0"
