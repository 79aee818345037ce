"""ResNet-50 v1 as PyTorch modules, in the Keras ``applications`` layout
that TF OD's ``ssd_resnet50_v1_fpn`` feature extractor wraps.

- the stem: zero padding of 3, a 7x7 stride-2 convolution to 64 channels,
  BatchNorm, ReLU; zero padding of 1 and a 3x3 stride-2 max pool;
- four stages of bottleneck blocks (filters, blocks, stride) ``STAGES``:
  ``ReLU(BN(conv1x1_4f(ReLU(BN(conv3x3_f(ReLU(BN(conv1x1_f,stride(x)))))))) +
  shortcut)``, the stride on the first 1x1 (v1, not v1.5), the shortcut a
  1x1 stride convolution and BatchNorm on each stage's first block and the
  identity elsewhere;
- the taps C3, C4 and C5: the last outputs of stages 2, 3 and 4 (512, 1024
  and 2048 channels at strides 8, 16 and 32).

No convolution carries a bias (BatchNorm's mean takes it), BatchNorm's eps
is 1e-3 as in the rest of the port. Module names give the flax paths
(models/weights.py): ``conv1`` the stem, ``conv{stage}_block{b}`` the
blocks with their ``conv1``, ``conv2``, ``conv3`` and ``shortcut`` units,
stages numbered 2 to 5 and blocks from 1, as Keras names them.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from watsor_tpu_torch.models.mobilenet_v2 import (batch_norm, conv_same,
                                                  make_bn)

# (filters, blocks, stride) of stages 2 to 5
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
# the RGB means TF OD's ResNet v1 extractors subtract from [0, 255] inputs
# (VGG's), with no scaling
CHANNEL_MEANS = (123.68, 116.779, 103.939)


class ConvBNReLU(nn.Module):
    """Convolution (no bias), BatchNorm, optional ReLU; 'SAME' padding, or
    ``padding`` zeros on every side."""

    FLAX_NAMES = {'conv': 'Conv_0', 'bn': 'BatchNorm_0'}

    def __init__(self, in_ch, out_ch, kernel=1, stride=1, relu=True,
                 padding=None):
        super().__init__()
        self.stride = stride
        self.relu = relu
        self.padding = padding
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              bias=False)
        self.bn = make_bn(out_ch)

    def forward(self, x):
        if self.padding is None:
            x = conv_same(x, self.conv.weight, None, self.stride)
        else:
            x = F.conv2d(x, self.conv.weight.to(x.dtype), None, self.stride,
                         self.padding)
        x = batch_norm(x, self.bn)
        return torch.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    """The v1 bottleneck block: the stride on the first 1x1."""

    def __init__(self, in_ch, filters, stride, project):
        super().__init__()
        self.conv1 = ConvBNReLU(in_ch, filters, 1, stride)
        self.conv2 = ConvBNReLU(filters, filters, 3)
        self.conv3 = ConvBNReLU(filters, 4 * filters, 1, relu=False)
        if project:
            self.shortcut = ConvBNReLU(in_ch, 4 * filters, 1, stride,
                                       relu=False)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        shortcut = self.shortcut(x) if hasattr(self, 'shortcut') else x
        return torch.relu(y + shortcut)


class ResNet50V1(nn.Module):
    """NCHW input (the family's mean-subtracted frames) -> (C3, C4, C5)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBNReLU(3, 64, 7, 2, padding=3)
        self.blocks = []
        in_ch = 64
        for stage, (filters, blocks, stride) in enumerate(STAGES, 2):
            for b in range(1, blocks + 1):
                name = 'conv{}_block{}'.format(stage, b)
                setattr(self, name, Bottleneck(
                    in_ch, filters, stride if b == 1 else 1, b == 1))
                self.blocks.append((stage, name))
                in_ch = 4 * filters
        self.out_channels = tuple(4 * f for f, _, _ in STAGES[1:])

    def forward(self, x):
        x = self.conv1(x)
        # zero padding then max pool: after the ReLU every value is at
        # least 0, so the pool's -inf padding gives the same maxima
        x = F.max_pool2d(x, 3, 2, padding=1)
        taps = []
        for i, (stage, name) in enumerate(self.blocks):
            x = getattr(self, name)(x)
            last = i + 1 == len(self.blocks) or self.blocks[i + 1][0] != stage
            if last and stage >= 3:
                taps.append(x)
        return tuple(taps)
