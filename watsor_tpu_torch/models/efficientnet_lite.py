"""EfficientNet-Lite backbone as PyTorch modules (counterpart of
watsor_tpu/models/efficientnet_lite.py, its plain path): the B0 block
table without squeeze-excite, relu6 throughout, scaled per variant in
width and depth, except that the stem (32) is not width-scaled and the
first and last stages are not depth-scaled. Returns the stride-8/16/32
taps (C3, C4, C5), the last block of stages 2, 4 and 6.

The JAX module's space-to-depth ``packing`` (a TPU lane-padding
workaround) is not ported.
"""

import math

import torch.nn as nn

from watsor_tpu_torch.models.mobilenet_v2 import ConvBNReLU6, InvertedResidual

# (expand, features, repeats, first_stride, kernel) — the B0 block table
EFFNET_B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width, depth) multipliers per lite variant
LITE_SCALING = {
    'lite0': (1.0, 1.0),
    'lite1': (1.0, 1.1),
    'lite2': (1.1, 1.2),
    'lite3': (1.2, 1.4),
    'lite4': (1.4, 1.8),
}
TAP_STAGES = (2, 4, 6)


def round_filters(filters, width_multiplier, divisor=8):
    filters *= width_multiplier
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def lite_block_args(variant):
    """[(expand_ratio, features, strides, kernel, stage), ...], one entry
    per MBConv block in execution order (block{i} in the flax tree)."""
    width, depth = LITE_SCALING[variant]
    args = []
    for stage, (expand, features, repeats, first_stride, kernel) in \
            enumerate(EFFNET_B0_BLOCKS):
        features = round_filters(features, width)
        if stage not in (0, len(EFFNET_B0_BLOCKS) - 1):
            repeats = int(math.ceil(depth * repeats))
        for i in range(repeats):
            args.append((expand, features, first_stride if i == 0 else 1,
                         kernel, stage))
    return args


class EfficientNetLite(nn.Module):
    """Stem and MBConv blocks; ``forward`` returns (C3, C4, C5)."""

    def __init__(self, variant='lite0'):
        super().__init__()
        self.plan = lite_block_args(variant)
        x_ch = 32                    # Lite: the stem is not width-scaled
        self.stem = ConvBNReLU6(3, x_ch, 3, stride=2)
        self.taps = []               # block indices whose output is a tap
        for index, (expand, features, strides, kernel, stage) in \
                enumerate(self.plan):
            setattr(self, 'block{}'.format(index),
                    InvertedResidual(x_ch, features, strides, expand, kernel))
            x_ch = features
            last_of_stage = index + 1 == len(self.plan) or \
                self.plan[index + 1][4] != stage
            if last_of_stage and stage in TAP_STAGES:
                self.taps.append(index)
        self.out_channels = tuple(self.plan[i][1] for i in self.taps)

    def forward(self, x):
        x = self.stem(x)
        taps = []
        for index in range(len(self.plan)):
            x = getattr(self, 'block{}'.format(index))(x)
            if index in self.taps:
                taps.append(x)
        return tuple(taps)
