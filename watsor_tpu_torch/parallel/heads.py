"""A head convolution split on its output channels over a model group: the
model axis of the (data, model) mesh, as GSPMD runs the SSD heads of
watsor_tpu/parallel/mesh.py:57-73 (kernel split on its output channels
over ``model``, bias replicated).

For data row i, device (i, j) holds output-channel slice j of the kernel.
The row's features (on (i, 0)) go to each device of the group, each slice
convolves them there, and the slices' outputs come back to (i, 0) in
channel order, where the full bias is added. Every step is a plain tensor
operation, so autograd carries the gradients back across the devices:
the fleet's detect step and the sharded train step both run it.
"""

import torch

from watsor_tpu_torch.models.mobilenet_v2 import conv_same


class SplitHead:
    """A head convolution ``(x) -> y`` whose kernel slices lie on the
    devices of a model group, in channel order; ``models/ssd.py
    apply_heads`` calls it in place of ``conv_same(x, weight, bias)``."""

    def __init__(self, slices, bias):
        self.slices = list(slices)
        self.bias = bias

    @classmethod
    def over(cls, weight, bias, devices):
        """``weight`` [O, I, kh, kw] split into ``len(devices)`` equal
        slices of output channels, slice j on ``devices[j]``; the bias
        stays where it is."""
        if weight.shape[0] % len(devices):
            raise ValueError('{} output channels do not split over {} '
                             'devices'.format(weight.shape[0], len(devices)))
        return cls([w.to(d) for w, d in
                    zip(weight.chunk(len(devices), 0), devices)], bias)

    def __call__(self, x):
        parts = [conv_same(x.to(w.device), w).to(x.device)
                 for w in self.slices]
        y = torch.cat(parts, dim=1)
        return y + self.bias.to(y.dtype)[:, None, None]
