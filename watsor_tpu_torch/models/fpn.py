"""The feature pyramid and the weight-shared predictor of TF OD's
``ssd_resnet50_v1_fpn`` (RetinaNet), as PyTorch modules.

``FPN`` over the backbone's taps C3, C4 and C5, at ``depth`` channels:
every lateral ``lateral{k}`` a 1x1 convolution with bias and no BatchNorm
or activation; T5 = L5(C5) is P5; T4 = up2(T5) + L4(C4) and T3 = up2(T4) +
L3(C3), each smoothed into P4 and P3 by a 3x3 convolution, BatchNorm and
relu6 (``smooth{k}``) while the unsmoothed T carries on down; P6 and P7 a
3x3 stride-2 'SAME' convolution, BatchNorm and relu6 (``coarse{k}``) of
the level before, from P5. up2 repeats each position 2x2 (nearest), cut
to the lateral's size where a level's side is odd.

``WeightSharedTower``: ``layers`` 3x3 convolutions without bias whose
weights every level shares (``conv{i}``), each followed by a BatchNorm of
its own for each level (``bn{i}_l{level}``) and relu6, then a 3x3
predictor with bias (``predict``), shared too.
"""

import torch.nn as nn

from watsor_tpu_torch.models.mobilenet_v2 import (ConvBNReLU6, batch_norm,
                                                  conv_same, make_bn, relu6)

# ssd_resnet50_v1_fpn's published FPN depth (the towers' width too) and the
# towers' layers before the predictor
FPN_DEPTH = 256
TOWER_LAYERS = 4


def up2(x, like):
    """NCHW ``x`` repeated 2x2, cut to the spatial size of ``like``."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :like.shape[2], :like.shape[3]]


class FPN(nn.Module):
    """(C3, C4, C5) -> [P3, ..., P{max_level}], ``depth`` channels each."""

    def __init__(self, in_channels, depth, max_level=7):
        super().__init__()
        for level, ch in zip((3, 4, 5), in_channels):
            setattr(self, 'lateral{}'.format(level), nn.Conv2d(ch, depth, 1))
        for level in (3, 4):
            setattr(self, 'smooth{}'.format(level),
                    ConvBNReLU6(depth, depth, 3))
        self.coarse = tuple(range(6, max_level + 1))
        for level in self.coarse:
            setattr(self, 'coarse{}'.format(level),
                    ConvBNReLU6(depth, depth, 3, stride=2))

    def lateral(self, level, c):
        conv = getattr(self, 'lateral{}'.format(level))
        return conv_same(c, conv.weight, conv.bias)

    def forward(self, taps):
        c3, c4, c5 = taps
        t5 = self.lateral(5, c5)
        l4 = self.lateral(4, c4)
        t4 = up2(t5, l4) + l4
        l3 = self.lateral(3, c3)
        t3 = up2(t4, l3) + l3
        feats = [self.smooth3(t3), self.smooth4(t4), t5]
        for level in self.coarse:
            feats.append(getattr(self, 'coarse{}'.format(level))(feats[-1]))
        return feats


class WeightSharedTower(nn.Module):
    """One tower (box or class) of the weight-shared predictor over the
    pyramid's levels -> the predictor's NCHW output a level."""

    def __init__(self, channels, out_features, layers, levels):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            setattr(self, 'conv{}'.format(i),
                    nn.Conv2d(channels, channels, 3, bias=False))
            for level in range(levels):
                setattr(self, 'bn{}_l{}'.format(i, level), make_bn(channels))
        self.predict = nn.Conv2d(channels, out_features, 3)

    def forward(self, feats):
        outputs = []
        for level, x in enumerate(feats):
            for i in range(self.layers):
                x = conv_same(x, getattr(self, 'conv{}'.format(i)).weight)
                x = relu6(batch_norm(x, getattr(self, 'bn{}_l{}'.format(
                    i, level))))
            outputs.append(conv_same(x, self.predict.weight,
                                     self.predict.bias))
        return outputs
