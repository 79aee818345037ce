"""InceptionV2 (BN-Inception) backbone as PyTorch modules (counterpart of
watsor_tpu/models/inception_v2.py), in the geometry of tf-slim's
``inception_v2`` as the TF-OD ssd_inception_v2 feature extractor uses it:
a separable 7x7 stem, Mixed_3b..Mixed_5c, and the SSD taps Mixed_4c
(19x19x576 at 300 input) and Mixed_5c (10x10x1024). Every unit is a
ConvBNReLU6 (BatchNorm eps 1e-3, relu6).

Pools pad as flax's 'SAME' does: the stride-2 max pools pad with -inf,
asymmetrically where TF does (mobilenet_v2.max_pool_same); the branch
average pool leaves the padding out of its divisor, as TF's does.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from watsor_tpu_torch.models.mobilenet_v2 import (ConvBNReLU6, batch_norm,
                                                  conv_same, make_bn,
                                                  max_pool_same, relu6)


class SeparableStem(nn.Module):
    """slim ``Conv2d_1a_7x7``: a 7x7 stride-2 depthwise with multiplier 8
    (3 groups of 8: 24 channels, flax's HWIO [7, 7, 1, 24] is OIHW
    [24, 1, 7, 7] in group-major order), a 1x1 pointwise to 64, and one
    BatchNorm + relu6 after the pointwise only."""

    FLAX_NAMES = {'bn': 'BatchNorm_0'}

    def __init__(self):
        super().__init__()
        self.dw = nn.Conv2d(3, 24, 7, stride=2, groups=3, bias=False)
        self.pw = nn.Conv2d(24, 64, 1, bias=False)
        self.bn = make_bn(64)

    def forward(self, x):
        x = conv_same(x, self.dw.weight, None, stride=2, groups=3)
        x = F.conv2d(x, self.pw.weight.to(x.dtype))
        return relu6(batch_norm(x, self.bn))


class Mixed(nn.Module):
    """Standard inception block: 1x1 | 1x1-3x3 | 1x1-3x3-3x3 | pool-1x1,
    concatenated in branch order (slim Branch_0..Branch_3)."""

    def __init__(self, in_ch, b0, b1, b2, b3, pool='avg'):
        super().__init__()
        self.pool = pool
        self.b0 = ConvBNReLU6(in_ch, b0, 1)
        self.b1_0 = ConvBNReLU6(in_ch, b1[0], 1)
        self.b1_1 = ConvBNReLU6(b1[0], b1[1], 3)
        self.b2_0 = ConvBNReLU6(in_ch, b2[0], 1)
        self.b2_1 = ConvBNReLU6(b2[0], b2[1], 3)
        self.b2_2 = ConvBNReLU6(b2[1], b2[2], 3)
        self.b3 = ConvBNReLU6(in_ch, b3, 1)
        self.out_channels = b0 + b1[1] + b2[2] + b3

    def forward(self, x):
        y0 = self.b0(x)
        y1 = self.b1_1(self.b1_0(x))
        y2 = self.b2_2(self.b2_1(self.b2_0(x)))
        if self.pool == 'max':
            y3 = max_pool_same(x, stride=1)
        else:
            y3 = F.avg_pool2d(x, 3, stride=1, padding=1,
                              count_include_pad=False)
        return torch.cat([y0, y1, y2, self.b3(y3)], dim=1)


class MixedReduction(nn.Module):
    """Stride-2 inception block (Mixed_4a / Mixed_5a): 1x1-3x3s2 |
    1x1-3x3-3x3s2 | maxpool-s2, concatenated."""

    def __init__(self, in_ch, b0, b1):
        super().__init__()
        self.b0_0 = ConvBNReLU6(in_ch, b0[0], 1)
        self.b0_1 = ConvBNReLU6(b0[0], b0[1], 3, stride=2)
        self.b1_0 = ConvBNReLU6(in_ch, b1[0], 1)
        self.b1_1 = ConvBNReLU6(b1[0], b1[1], 3)
        self.b1_2 = ConvBNReLU6(b1[1], b1[2], 3, stride=2)
        self.out_channels = b0[1] + b1[2] + in_ch

    def forward(self, x):
        y0 = self.b0_1(self.b0_0(x))
        y1 = self.b1_2(self.b1_1(self.b1_0(x)))
        return torch.cat([y0, y1, max_pool_same(x)], dim=1)


# copied from watsor_tpu/models/inception_v2.py:100-112: (name, b0, b1, b2,
# b3, pool) in slim inception_v2_base order; rows with b0 None are the
# stride-2 reductions
INCEPTION_V2_BLOCKS = (
    ('mixed_3b', 64, (64, 64), (64, 96, 96), 32, 'avg'),
    ('mixed_3c', 64, (64, 96), (64, 96, 96), 64, 'avg'),
    ('mixed_4a', None, (128, 160), (64, 96, 96), None, None),
    ('mixed_4b', 224, (64, 96), (96, 128, 128), 128, 'avg'),
    ('mixed_4c', 192, (96, 128), (96, 128, 128), 128, 'avg'),
    ('mixed_4d', 160, (128, 160), (128, 160, 160), 96, 'avg'),
    ('mixed_4e', 96, (128, 192), (160, 192, 192), 96, 'avg'),
    ('mixed_5a', None, (128, 192), (192, 256, 256), None, None),
    ('mixed_5b', 352, (192, 320), (160, 224, 224), 128, 'avg'),
    ('mixed_5c', 352, (192, 320), (192, 224, 224), 128, 'max'),
)
TAP_BLOCK = 'mixed_4c'


class InceptionV2Backbone(nn.Module):
    """Returns the SSD taps (Mixed_4c, Mixed_5c)."""

    def __init__(self):
        super().__init__()
        self.stem = SeparableStem()
        self.conv2b = ConvBNReLU6(64, 64, 1)
        self.conv2c = ConvBNReLU6(64, 192, 3)
        x_ch = 192
        for name, b0, b1, b2, b3, pool in INCEPTION_V2_BLOCKS:
            block = MixedReduction(x_ch, b1, b2) if b0 is None else \
                Mixed(x_ch, b0, b1, b2, b3, pool)
            setattr(self, name, block)
            x_ch = block.out_channels
        self.out_channels = (getattr(self, TAP_BLOCK).out_channels, x_ch)

    def forward(self, x):
        x = max_pool_same(self.stem(x))
        x = max_pool_same(self.conv2c(self.conv2b(x)))
        c4 = None
        for name, *_ in INCEPTION_V2_BLOCKS:
            x = getattr(self, name)(x)
            if name == TAP_BLOCK:
                c4 = x
        return c4, x
