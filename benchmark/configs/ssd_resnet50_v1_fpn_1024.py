"""Plain reference of TF OD's "SSD ResNet50 V1 FPN 1024x1024 (RetinaNet50)"
(research/object_detection/configs/tf2/
ssd_resnet50_v1_fpn_1024x1024_coco17_tpu-8.config): ResNet-50 v1 in the
Keras applications layout (a 7x7 stride-2 stem after zero padding of 3,
a 3x3 stride-2 max pool after zero padding of 1, bottleneck blocks with
the stride on the first 1x1, ReLU), an FPN of depth 256 on P3 to P7
(linear 1x1 laterals with bias, a nearest 2x top-down path, 3x3
smoothing of P3 and P4 and 3x3 stride-2 P6 and P7 from P5, each with
BatchNorm and relu6), and the weight-shared box and class towers (4 3x3
convolutions shared by the levels, a BatchNorm a level, relu6) and their
3x3 predictors with bias; multiscale anchors of 2 scales an octave and 3
aspect ratios a cell.

Every size comes from the configuration's file. Inputs are [0, 255] NHWC
frames at the model's size, less the channel means; outputs are box
encodings [B, A, 4] and logits [B, A, num_classes + 1] (column 0 the
background). ``stage_flops`` counts one frame's backbone, FPN and heads.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.lib.plain import Weights, batch_norm, conv, layout, relu6, unit

# (filters, blocks, stride) of stages 2 to 5
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def relu(x):
    return x.clamp_min(0.0)


def conv_bn(w, path, x, cout, k=1, stride=1, act=True):
    """'SAME' convolution without bias, BatchNorm, ReLU if ``act``."""
    x = conv(w, path + '/Conv_0', x, cout, k, stride)
    x = batch_norm(w, path + '/BatchNorm_0', x)
    return relu(x) if act else x


def stem(w, x):
    """Zero padding of 3, the 7x7 stride-2 convolution ('VALID' after the
    padding), BatchNorm, ReLU; zero padding of 1, the 3x3 stride-2 max
    pool."""
    path = 'backbone/conv1'
    kernel = w.get('params/{}/Conv_0/kernel'.format(path), (7, 7, 3, 64),
                   'kernel', 7 * 7 * 3)
    if w.quantize is not None:
        x, kernel = w.quantize(x), w.quantize(kernel)
    y = F.conv2d(F.pad(x, (3, 3, 3, 3)),
                 kernel.permute(3, 2, 0, 1).to(x.dtype), stride=2)
    if w.quantize is not None:
        y = w.quantize(y)
    y = relu(batch_norm(w, path + '/BatchNorm_0', y))
    return F.max_pool2d(F.pad(y, (1, 1, 1, 1)), 3, 2)


def bottleneck(w, path, x, filters, stride, project):
    y = conv_bn(w, path + '/conv1', x, filters, 1, stride)
    y = conv_bn(w, path + '/conv2', y, filters, 3)
    y = conv_bn(w, path + '/conv3', y, 4 * filters, act=False)
    shortcut = conv_bn(w, path + '/shortcut', x, 4 * filters, 1, stride,
                       act=False) if project else x
    return relu(y + shortcut)


def backbone(w, x, cfg):
    """[C3, C4, C5] of the mean-subtracted NCHW frames."""
    x = stem(w, x)
    taps = []
    for stage, (filters, blocks, stride) in enumerate(STAGES, 2):
        for b in range(1, blocks + 1):
            x = bottleneck(w, 'backbone/conv{}_block{}'.format(stage, b), x,
                           filters, stride if b == 1 else 1, b == 1)
        if stage >= 3:
            taps.append(x)
    return taps


def up2(x, like):
    """Each position repeated 2x2, cut to ``like``'s spatial size."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :like.shape[2], :like.shape[3]]


def fpn(w, taps, cfg):
    """[P3, ..., P{max_level}] of the backbone's taps."""
    depth = cfg['fpn_depth']
    c3, c4, c5 = taps
    t5 = conv(w, 'fpn/lateral5', c5, depth, bias=True)
    l4 = conv(w, 'fpn/lateral4', c4, depth, bias=True)
    t4 = up2(t5, l4) + l4
    l3 = conv(w, 'fpn/lateral3', c3, depth, bias=True)
    t3 = up2(t4, l3) + l3
    feats = [unit(w, 'fpn/smooth3', t3, depth, 3),
             unit(w, 'fpn/smooth4', t4, depth, 3), t5]
    for level in range(6, cfg['max_level'] + 1):
        feats.append(unit(w, 'fpn/coarse{}'.format(level), feats[-1], depth,
                          3, 2))
    return feats


def tower(w, path, feats, cout, layers, bias_kind):
    """A weight-shared tower and its predictor over every level."""
    outs = []
    for level, x in enumerate(feats):
        for i in range(layers):
            x = conv(w, '{}/conv{}'.format(path, i), x, x.shape[1], 3)
            x = relu6(batch_norm(w, '{}/bn{}_l{}'.format(path, i, level), x))
        outs.append(conv(w, path + '/predict', x, cout, 3, bias=True,
                         bias_kind=bias_kind))
    return outs


def heads(w, feats, cfg):
    per_cell = cfg['scales_per_octave'] * len(cfg['aspect_ratios'])
    ncls = cfg['num_classes'] + 1
    layers = cfg['tower_layers']
    box = tower(w, 'box_tower', feats, per_cell * 4, layers, 'box_bias')
    cls = tower(w, 'cls_tower', feats, per_cell * ncls, layers, 'cls_bias')
    batch = feats[0].shape[0]
    return (torch.cat([b.permute(0, 2, 3, 1).reshape(batch, -1, 4)
                       for b in box], 1),
            torch.cat([c.permute(0, 2, 3, 1).reshape(batch, -1, ncls)
                       for c in cls], 1))


def normalize(images, cfg):
    """[0, 255] NHWC -> NCHW less the channel means."""
    means = torch.tensor(cfg['channel_means'], dtype=images.dtype,
                         device=images.device)
    return (images - means).permute(0, 3, 1, 2)


def forward(w, images, cfg):
    return heads(w, fpn(w, backbone(w, normalize(images, cfg), cfg), cfg),
                 cfg)


def anchors(cfg):
    """[A, 4] ymin, xmin, ymax, xmax on P3 to P{max_level}: base size
    anchor_scale x stride x 2^(k / scales_per_octave), the aspect ratios
    inside each scale, the anchor within a cell fastest."""
    size = cfg['input_size']
    d, dims = size, {}
    for level in range(1, cfg['max_level'] + 1):
        d = math.ceil(d / 2)
        dims[level] = d
    out = []
    scales = cfg['scales_per_octave']
    for level in range(cfg['min_level'], cfg['max_level'] + 1):
        n = dims[level]
        stride = size / n
        centers = (np.arange(n, dtype=np.float32) + 0.5) * stride / size
        yc, xc = np.meshgrid(centers, centers, indexing='ij')
        hs, ws = [], []
        for k in range(scales):
            base = cfg['anchor_scale'] * stride * 2 ** (k / scales)
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
    """The logit column of each 1-based label (column 0 the background)."""
    return list(labels)


def stage_flops(cfg):
    """{'backbone', 'fpn', 'heads'}: the operations of one frame's stage
    (the towers and predictors in 'heads'), as FlopCounterMode counts them
    (convolutions, two a multiply-add), on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    size = cfg['input_size']
    tree = {leaf.path: torch.empty(leaf.shape, device='meta')
            for leaf in layout(forward, cfg, size)}
    w = Weights(tree)
    x = normalize(torch.empty((1, size, size, 3), device='meta'), cfg)
    out = {}
    for name, stage in (('backbone', backbone), ('fpn', fpn),
                        ('heads', heads)):
        counter = FlopCounterMode(display=False)
        with counter:
            x = stage(w, x, cfg)
        out[name] = counter.get_total_flops()
    return out
