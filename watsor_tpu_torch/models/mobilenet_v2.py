"""MobileNetV2 backbone as PyTorch modules (counterpart of
watsor_tpu/models/mobilenet_v2.py).

Modules run NCHW tensors, kept ``channels_last`` so that their storage is
the NHWC of the JAX package. Convolutions pad like TF/flax 'SAME', which
is asymmetric at stride 2 (300 -> 150 pads (0, 1), 75 -> 38 pads (1, 1)),
so the padding is computed for each layer from its input size. BatchNorm
uses eps 1e-3 and runs in f32 on whatever dtype the convolutions produce.
Every convolution casts its weight to the activation dtype where it is
applied, as a flax ``Conv(dtype=...)`` does: the trainer keeps f32
parameters under bf16 activations; on the serving path, whose weights are
already in that dtype, the cast is a no-op.
Module names follow the flax parameter tree so the weight bridge
(models/weights.py) maps one onto the other by path; a module whose
children carry other names in flax says so in ``FLAX_NAMES``.
"""

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3

# the moment exchange of the sharded train step this thread runs a shard
# of (parallel/fleet.py), if any
_EXCHANGE = threading.local()

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


# copied from watsor_tpu/models/mobilenet_v2.py:21-27 (that module imports
# flax)
def make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:  # never round down by more than 10%
        new_v += divisor
    return new_v


# copied from watsor_tpu/models/ssd_int8.py:42-51 (that module imports jax),
# with the width multiplier of watsor_tpu/models/mobilenet_v2.py:93-96; at
# width 1.0 every feature count is already a multiple of 8
def block_plan(width_multiplier=1.0):
    """(index, expand_ratio, features, strides) for blocks 0..16."""
    plan = []
    index = 0
    for expand, features, repeats, first_stride in MOBILENET_V2_BLOCKS:
        features = make_divisible(features * width_multiplier)
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
    """NCHW conv2d with TF 'SAME' padding computed from the input size,
    weight and bias cast to the activation dtype."""
    weight = weight.to(x.dtype)
    if bias is not None:
        bias = bias.to(x.dtype)
    kh, kw = weight.shape[2:]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride=stride, padding=(top, left),
                        groups=groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, bias, stride=stride, groups=groups)


def max_pool_same(x, stride=2, kernel=3):
    """flax ``max_pool(padding='SAME')``: the TF 'SAME' padding, which is
    asymmetric at stride 2 on some sizes, filled with -inf."""
    top, bottom = same_padding(x.shape[2], kernel, stride)
    left, right = same_padding(x.shape[3], kernel, stride)
    x = F.pad(x, (left, right, top, bottom), value=float('-inf'))
    return F.max_pool2d(x, kernel, stride)


def relu6(x):
    return x.clamp(0.0, 6.0)


@contextlib.contextmanager
def exchanging_moments(exchange, shard):
    """Within the block, this thread's train-mode BatchNorms take the batch
    moments of the global batch from ``exchange`` (parallel/fleet.py
    ``MomentExchange``), as data shard ``shard``."""
    _EXCHANGE.current = exchange, shard
    try:
        yield
    finally:
        _EXCHANGE.current = None


def update_running(bn, mean, var):
    """Move ``bn``'s running statistics toward the batch moments, as flax
    does: ``running = (1 - r) * running + r * batch`` with r =
    ``bn.momentum`` (torch's convention: flax's momentum m is r = 1 - m).
    With ``bn.momentum`` None, r = 1 / n at the n-th batch since
    ``num_batches_tracked`` was 0, so the running statistics are the mean
    of the batch moments (precise BN)."""
    with torch.no_grad():
        if bn.momentum is None:
            bn.num_batches_tracked += 1
            rate = 1.0 / int(bn.num_batches_tracked)
        else:
            rate = bn.momentum
        for running, batch in ((bn.running_mean, mean),
                               (bn.running_var, var)):
            running.mul_(1.0 - rate).add_(rate * batch)


def batch_norm(x, bn):
    """BatchNorm with ``bn``'s f32 parameters. In eval mode it normalizes
    with the running statistics. In train mode (``bn.training``) it does
    what flax's ``BatchNorm(use_running_average=False)`` does: the moments
    over N, H, W in f32 (or wider) whatever the activation dtype, the
    biased variance as E[x^2] - E[x]^2 clipped at 0, the output in the
    activation dtype, and the running statistics moved once
    (``update_running``). ``F.batch_norm(training=True)`` would store the
    unbiased variance: n / (n - 1) off at a 1x1 map. Inside a sharded
    train step (``exchanging_moments``) the moments are those of the
    global batch, and the exchange moves the running statistics."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    current = getattr(_EXCHANGE, 'current', None)
    if current is not None:
        exchange, shard = current
        mean, var = exchange.moments(shard, bn, xf)
    else:
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        update_running(bn, mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + \
        bn.bias[:, None, None]
    return y.to(x.dtype)


def make_bn(channels):
    """BatchNorm as flax's: eps 1e-3, flax momentum 0.997 (torch's 0.003;
    EfficientDet sets its own)."""
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.003)


class ConvBNReLU6(nn.Module):
    """Conv (no bias) -> BatchNorm -> optional relu6: flax ``ConvBNRelu6``,
    whose ``Conv_0`` and ``BatchNorm_0`` are ``conv`` and ``bn`` here."""

    FLAX_NAMES = {'conv': 'Conv_0', 'bn': 'BatchNorm_0'}

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1,
                 use_relu=True):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.use_relu = use_relu
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              groups=groups, bias=False)
        self.bn = make_bn(out_ch)

    def forward(self, x):
        x = conv_same(x, self.conv.weight, None, self.stride, self.groups)
        x = batch_norm(x, self.bn)
        return relu6(x) if self.use_relu else x


class InvertedResidual(nn.Module):
    """The MobileNetV2 block, and EfficientNet-Lite's MBConv (no
    squeeze-excite) with its 3x3 or 5x5 depthwise ``kernel``."""

    def __init__(self, in_ch, out_ch, stride, expand_ratio, kernel=3):
        super().__init__()
        hidden = in_ch * expand_ratio
        self.residual = stride == 1 and in_ch == out_ch
        if expand_ratio != 1:
            self.expand = ConvBNReLU6(in_ch, hidden, 1)
        self.depthwise = ConvBNReLU6(hidden, hidden, kernel, stride=stride,
                                     groups=hidden)
        self.project = ConvBNReLU6(hidden, out_ch, 1, use_relu=False)

    def forward(self, x):
        y = self.expand(x) if hasattr(self, 'expand') else x
        y = self.project(self.depthwise(y))
        return y + x if self.residual else y


class MobileNetV2Backbone(nn.Module):
    """Returns the two SSD feature taps: block 13's expansion (stride 16,
    576 channels at width 1.0) and the final stride-32 map (1280)."""

    def __init__(self, width_multiplier=1.0):
        super().__init__()
        x_ch = make_divisible(32 * width_multiplier)
        self.stem = ConvBNReLU6(3, x_ch, 3, stride=2)
        self.plan = block_plan(width_multiplier)
        for index, expand, features, strides in self.plan:
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
        self.head = ConvBNReLU6(
            x_ch, make_divisible(1280 * max(width_multiplier, 1.0)), 1)
        self.out_channels = (self.block13_expand.conv.out_channels,
                             self.head.conv.out_channels)

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
