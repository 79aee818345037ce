"""MobileNetV2 backbone as PyTorch modules (counterpart of
watsor_tpu/models/mobilenet_v2.py).

Modules run NCHW tensors, kept ``channels_last`` so that their storage is
the NHWC of the JAX package. Convolutions pad like TF/flax 'SAME', which
is asymmetric at stride 2 (300 -> 150 pads (0, 1), 75 -> 38 pads (1, 1)),
so the padding is computed for each layer from its input size. BatchNorm
uses eps 1e-3 and runs in f32 on whatever dtype the convolutions produce.
Module names follow the flax parameter tree so the weight bridge
(models/weights.py) maps one onto the other by path.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3

# (expand_ratio, features, repeats, first_stride)
MOBILENET_V2_BLOCKS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# the block whose expansion is the stride-16 SSD feature tap
TAP_BLOCK = 13


# copied from watsor_tpu/models/ssd_int8.py:42-51 (that module imports jax);
# at width 1.0 every feature count is already a multiple of 8
def block_plan():
    """(index, expand_ratio, features, strides) for blocks 0..16."""
    plan = []
    index = 0
    for expand, features, repeats, first_stride in MOBILENET_V2_BLOCKS:
        for i in range(repeats):
            plan.append((index, expand, features,
                         first_stride if i == 0 else 1))
            index += 1
    return plan


def same_padding(size, kernel, stride):
    """TF 'SAME' (before, after) padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x, weight, bias=None, stride=1, groups=1):
    """NCHW conv2d with TF 'SAME' padding computed from the input size."""
    kh, kw = weight.shape[2:]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride=stride, padding=(top, left),
                        groups=groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, bias, stride=stride, groups=groups)


def relu6(x):
    return x.clamp(0.0, 6.0)


class ConvBNReLU6(nn.Module):
    """Conv (no bias) -> BatchNorm -> optional relu6: flax ``ConvBNRelu6``,
    whose ``Conv_0`` and ``BatchNorm_0`` are ``conv`` and ``bn`` here."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1,
                 use_relu=True):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.use_relu = use_relu
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=BN_EPS, momentum=0.003)

    def forward(self, x):
        x = conv_same(x, self.conv.weight, None, self.stride, self.groups)
        bn = self.bn
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return relu6(x) if self.use_relu else x


class InvertedResidual(nn.Module):
    def __init__(self, in_ch, out_ch, stride, expand_ratio):
        super().__init__()
        hidden = in_ch * expand_ratio
        self.residual = stride == 1 and in_ch == out_ch
        if expand_ratio != 1:
            self.expand = ConvBNReLU6(in_ch, hidden, 1)
        self.depthwise = ConvBNReLU6(hidden, hidden, 3, stride=stride,
                                     groups=hidden)
        self.project = ConvBNReLU6(hidden, out_ch, 1, use_relu=False)

    def forward(self, x):
        y = self.expand(x) if hasattr(self, 'expand') else x
        y = self.project(self.depthwise(y))
        return y + x if self.residual else y


class MobileNetV2Backbone(nn.Module):
    """Width 1.0. Returns the two SSD feature taps: block 13's expansion
    (stride 16, 576 channels) and the final 1280-channel stride-32 map."""

    def __init__(self):
        super().__init__()
        x_ch = 32
        self.stem = ConvBNReLU6(3, x_ch, 3, stride=2)
        for index, expand, features, strides in block_plan():
            if index == TAP_BLOCK:
                hidden = x_ch * expand
                setattr(self, 'block13_expand',
                        ConvBNReLU6(x_ch, hidden, 1))
                setattr(self, 'block13_depthwise',
                        ConvBNReLU6(hidden, hidden, 3, stride=strides,
                                    groups=hidden))
                setattr(self, 'block13_project',
                        ConvBNReLU6(hidden, features, 1, use_relu=False))
            else:
                setattr(self, 'block{}'.format(index),
                        InvertedResidual(x_ch, features, strides, expand))
            x_ch = features
        self.plan = block_plan()
        self.head = ConvBNReLU6(x_ch, 1280, 1)

    def forward(self, x):
        x = self.stem(x)
        tap_c4 = None
        for index, _, _, _ in self.plan:
            if index == TAP_BLOCK:
                tap_c4 = self.block13_expand(x)
                x = self.block13_project(self.block13_depthwise(tap_c4))
            else:
                x = getattr(self, 'block{}'.format(index))(x)
        return tap_c4, self.head(x)


def cast_convs(module: nn.Module, dtype: torch.dtype):
    """Cast every convolution's weights to the activation dtype; BatchNorm
    parameters and statistics stay f32."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype)
    return module
