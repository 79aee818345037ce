"""MobileNetV1 backbone as PyTorch modules (counterpart of
watsor_tpu/models/mobilenet_v1.py): a stride-2 stem and 13
depthwise-separable units, each a 3x3 depthwise and a 1x1 pointwise with
BatchNorm and relu6. The SSD taps are unit 11's pointwise output (stride
16, 512 channels) and unit 13's (stride 32, 1024 channels), as in the
TF-OD ssd_mobilenet_v1 feature extractor.
"""

import torch.nn as nn

from watsor_tpu_torch.models.mobilenet_v2 import ConvBNReLU6, make_divisible

# (strides of the depthwise, pointwise output channels) for units 1..13
MOBILENET_V1_UNITS = (
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
    (2, 1024), (1, 1024),
)
TAP_UNIT = 11


class MobileNetV1Backbone(nn.Module):
    """Returns (C4, C5): the unit-11 and unit-13 pointwise outputs."""

    def __init__(self, width_multiplier=1.0):
        super().__init__()
        x_ch = make_divisible(32 * width_multiplier)
        self.stem = ConvBNReLU6(3, x_ch, 3, stride=2)
        taps = []
        for n, (strides, features) in enumerate(MOBILENET_V1_UNITS, start=1):
            out_ch = make_divisible(features * width_multiplier)
            setattr(self, 'unit{}_depthwise'.format(n),
                    ConvBNReLU6(x_ch, x_ch, 3, stride=strides, groups=x_ch))
            setattr(self, 'unit{}_pointwise'.format(n),
                    ConvBNReLU6(x_ch, out_ch, 1))
            x_ch = out_ch
            if n in (TAP_UNIT, len(MOBILENET_V1_UNITS)):
                taps.append(out_ch)
        self.out_channels = tuple(taps)

    def forward(self, x):
        x = self.stem(x)
        tap_c4 = None
        for n in range(1, len(MOBILENET_V1_UNITS) + 1):
            x = getattr(self, 'unit{}_depthwise'.format(n))(x)
            x = getattr(self, 'unit{}_pointwise'.format(n))(x)
            if n == TAP_UNIT:
                tap_c4 = x
        return tap_c4, x
