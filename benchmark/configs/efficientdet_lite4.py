"""Plain reference of EfficientDet-Lite (google/automl, efficientdet/
keras/efficientdet_keras.py with the Lite settings of hparams_config.py):
the EfficientNet-Lite backbone (the B0 block table without squeeze-excite,
relu6, scaled in width and depth except the 32-channel stem and the first
and last stages), P6 from a 1x1 convolution and BatchNorm of C5 and a 3x3
stride-2 max pool, P7 a pool of P6, BiFPN cells of plain-sum fusion (relu6,
a separable convolution with bias, BatchNorm; the first cell projecting
the backbone's taps inside the nodes that read them), and separable class
and box heads shared by the levels with a BatchNorm a level; anchors of
three octave scales and three aspect ratios a cell on P3 to P7.

Every size comes from the configuration's file. Inputs are [0, 255] NHWC
frames at the model's size, normalized as (x - 127) / 128; outputs are box
encodings [B, A, 4] and logits [B, A, num_classes] (no background column).
"""

import math

import numpy as np
import torch

from benchmark.lib.plain import (batch_norm, conv, inverted_residual,
                                 max_pool_same, relu6, unit,
                                 upsample_nearest)

# (expand, features, repeats, first_stride, kernel): EfficientNet-B0
BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
          (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
          (6, 320, 1, 1, 3))
TAP_STAGES = (2, 4, 6)
# BiFPN nodes: (inputs, the input a first cell projects or -1); p*td are
# the top-down nodes, p*out the outputs
NODES = ((('p6', 'p7'), -1), (('p5', 'p6td'), 0), (('p4', 'p5td'), 0),
         (('p3', 'p4td'), 0), (('p4', 'p4td', 'p3out'), 0),
         (('p5', 'p5td', 'p4out'), 0), (('p6', 'p6td', 'p5out'), -1),
         (('p7', 'p6out'), -1))
OUTPUTS = ('p6td', 'p5td', 'p4td', 'p3out', 'p4out', 'p5out', 'p6out',
           'p7out')


def round_filters(filters, width, divisor=8):
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * filters else new)


def block_plan(cfg):
    """(expand, features, stride, kernel, stage) of each MBConv block."""
    width, depth = cfg['width_multiplier'], cfg['depth_multiplier']
    plan = []
    for stage, (expand, features, repeats, stride, k) in enumerate(BLOCKS):
        if stage not in (0, len(BLOCKS) - 1):
            repeats = int(math.ceil(depth * repeats))
        for i in range(repeats):
            plan.append((expand, round_filters(features, width),
                         stride if i == 0 else 1, k, stage))
    return plan


def backbone(w, x, cfg):
    x = unit(w, 'backbone/stem', x, 32, 3, 2)
    plan = block_plan(cfg)
    taps = []
    for i, (expand, features, stride, k, stage) in enumerate(plan):
        x = inverted_residual(w, 'backbone/block{}'.format(i), x, features,
                              stride, expand, k)
        last = i + 1 == len(plan) or plan[i + 1][4] != stage
        if last and stage in TAP_STAGES:
            taps.append(x)
    return taps


def separable(w, path, x, cout, bias_kind='bias'):
    x = conv(w, path + '/dw', x, x.shape[1], 3, groups=x.shape[1])
    return conv(w, path + '/pw', x, cout, bias=True, bias_kind=bias_kind)


def bifpn(w, path, feats, channels, first):
    level = dict(zip(('p3', 'p4', 'p5', 'p6', 'p7'), feats))
    out = dict(level)
    for k, (names, project) in enumerate(NODES):
        node = '{}/fnode{}'.format(path, k)
        xs = [out[n] for n in names]
        target = level[names[0]].shape[2:]
        if k < 4:
            xs[1] = upsample_nearest(xs[1], *target)
        else:
            xs[-1] = max_pool_same(xs[-1])
        if first and project >= 0:
            xs[project] = unit(w, node + '/resample', xs[project], channels,
                               relu=False)
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        y = separable(w, node + '/conv', relu6(y), channels)
        out[OUTPUTS[k]] = batch_norm(w, node + '/bn', y)
    return [out[n] for n in ('p3out', 'p4out', 'p5out', 'p6out', 'p7out')]


def head(w, path, feats, cout, repeats, bias_kind='bias'):
    outs = []
    for level, x in enumerate(feats):
        for r in range(repeats):
            x = separable(w, '{}/sep{}'.format(path, r), x, x.shape[1])
            x = relu6(batch_norm(w, '{}/bn{}_l{}'.format(path, r, level), x))
        outs.append(separable(w, path + '/predict', x, cout, bias_kind))
    return outs


def forward(w, images, cfg):
    x = (images.permute(0, 3, 1, 2) - cfg['mean_rgb']) / cfg['stddev_rgb']
    c3, c4, c5 = backbone(w, x, cfg)
    fpn = cfg['fpn_channels']
    p6 = max_pool_same(unit(w, 'resample_p6', c5, fpn, relu=False))
    feats = [c3, c4, c5, p6, max_pool_same(p6)]
    for r in range(cfg['fpn_repeats']):
        feats = bifpn(w, 'bifpn{}'.format(r), feats, fpn, r == 0)
    per_cell = cfg['num_scales'] * len(cfg['aspect_ratios'])
    ncls = cfg['num_classes']
    cls = head(w, 'cls_head', feats, per_cell * ncls, cfg['head_repeats'],
               'cls_bias')
    box = head(w, 'box_head', feats, per_cell * 4, cfg['head_repeats'],
               'box_bias')
    batch = images.shape[0]
    return (torch.cat([b.permute(0, 2, 3, 1).reshape(batch, -1, 4)
                       for b in box], 1),
            torch.cat([c.permute(0, 2, 3, 1).reshape(batch, -1, ncls)
                       for c in cls], 1))


def anchors(cfg):
    """[A, 4] ymin, xmin, ymax, xmax on P3 to P7: base size anchor_scale x
    stride, octave scales 2^(i / num_scales), the anchor within a cell
    fastest."""
    size = cfg['input_size']
    d, dims = size, {}
    for level in range(1, cfg['max_level'] + 1):
        d = math.ceil(d / 2)
        dims[level] = d
    out = []
    for level in range(cfg['min_level'], cfg['max_level'] + 1):
        n = dims[level]
        stride = size / n
        centers = (np.arange(n, dtype=np.float32) + 0.5) * stride / size
        yc, xc = np.meshgrid(centers, centers, indexing='ij')
        hs, ws = [], []
        for octave in range(cfg['num_scales']):
            base = cfg['anchor_scale'] * stride * 2 ** (octave /
                                                        cfg['num_scales'])
            for aspect in cfg['aspect_ratios']:
                hs.append(base / math.sqrt(aspect) / size)
                ws.append(base * math.sqrt(aspect) / size)
        h = np.array(hs, np.float32)
        w = np.array(ws, np.float32)
        yc, xc = yc[..., None], xc[..., None]
        out.append(np.stack([yc - 0.5 * h, xc - 0.5 * w, yc + 0.5 * h,
                             xc + 0.5 * w], -1).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def label_columns(cfg, labels):
    """The logit column of each 1-based label (no background column)."""
    return [label - 1 for label in labels]
