"""EfficientDet-Lite detector as PyTorch modules (counterpart of
watsor_tpu/models/efficientdet.py): the EfficientNet-Lite backbone, BiFPN
cells over P3..P7, and separable-conv heads shared across levels with a
BatchNorm per level, with the same uint8-in -> detections-out step as the
SSD family (models/ssd.py ``make_detect_batch``).

As in the JAX module, which matches the google/automl computation:

- relu6 activations, no squeeze-excite; plain-sum fusion in the BiFPN
  (``'sum'``, the Lite choice) or fast attention over per-node ``WSM``
  weights (``'fastattn'``);
- a fusion node applies relu6 before its separable conv (which carries a
  bias) and a BatchNorm after it, with no second activation;
- the first cell projects the raw backbone taps inside the nodes that
  read them ("resample"), P4 and P5 twice with separate weights;
- class logits have no background column (column i is label i + 1);
- inputs normalize as (x - 127) / 128.

Between levels, upsampling is the nearest resize of ``jax.image.resize``:
output pixel i reads input floor((i + 0.5) * in / out), which at 2x is a
repeat and at 3 -> 5 (P7 -> P6 at 320x320) reads [0, 0, 1, 2, 2];
downsampling is a 3x3 stride-2 max pool, 'SAME'-padded with -inf.
The JAX package's space-to-depth ``packing`` and its ``WATSOR_UPSAMPLE``
A/B (two TPU lowerings of one result) are not ported.
"""

from functools import lru_cache
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from watsor_tpu_torch.models.efficientnet_lite import EfficientNetLite
from watsor_tpu_torch.models.mobilenet_v2 import (ConvBNReLU6, batch_norm,
                                                  conv_same, make_bn,
                                                  max_pool_same, relu6)
from watsor_tpu_torch.models.ssd import (Detector, check_anchors,
                                         make_detect_batch, place_model,
                                         resolve_device)
from watsor_tpu_torch.ops.anchors import multilevel_anchors, pyramid_shapes

# flax momentum of every BatchNorm of the family (backbone, BiFPN, heads)
EFFDET_BN_MOMENTUM = 0.99

# published EfficientDet-Lite compound scaling:
# variant -> (input_size, fpn_channels, fpn_repeats, head_repeats,
#             anchor_scale)
LITE_DET_SCALING = {
    'lite0': (320, 64, 3, 3, 3.0),
    'lite1': (384, 88, 4, 3, 3.0),
    'lite2': (448, 112, 5, 3, 3.0),
    'lite3': (512, 160, 6, 4, 4.0),
    'lite4': (640, 224, 7, 4, 4.0),
}


def lite_config(variant='lite0', **overrides):
    """EfficientDetConfig with the published per-variant scaling."""
    if variant not in LITE_DET_SCALING:
        raise ValueError(
            'unknown EfficientDet-Lite variant {!r}; supported: {}'.format(
                variant, ', '.join(sorted(LITE_DET_SCALING))))
    size, channels, fpn_r, head_r, anchor_scale = LITE_DET_SCALING[variant]
    return EfficientDetConfig(variant=variant, input_size=size,
                              fpn_channels=channels, fpn_repeats=fpn_r,
                              head_repeats=head_r,
                              anchor_scale=anchor_scale)._replace(**overrides)


class EfficientDetConfig(NamedTuple):
    """The JAX package's EfficientDetConfig without ``packing``."""

    num_classes: int = 90
    variant: str = 'lite0'
    input_size: int = 320
    fpn_channels: int = 64
    fpn_repeats: int = 3
    head_repeats: int = 3
    min_level: int = 3
    max_level: int = 7
    num_scales: int = 3
    aspect_ratios: Tuple[float, ...] = (1.0, 2.0, 0.5)
    anchor_scale: float = 3.0      # lite0-2 use 3.0, lite3/4 use 4.0
    fpn_weight_method: str = 'sum'  # 'sum' (Lite) | 'fastattn'
    explicit_background: bool = False  # automl: sigmoid heads, no bg column
    mean_rgb: float = 127.0        # Lite input normalization (x-127)/128
    stddev_rgb: float = 128.0
    iou_threshold: float = 0.6
    score_threshold: float = 0.005
    max_detections: int = 100
    box_coder_scales: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    nms_mode: str = 'fused'
    active_labels: Any = None      # restrict post-processing (see SSDConfig)
    dtype: Any = torch.bfloat16
    # run cls_head and box_head as one twice-wide stack (the JAX package's
    # _DualHead; WATSOR_FUSED_HEADS=1); stored weights keep the two-head
    # layout and build_effdet fuses them
    fused_heads: bool = False

    @property
    def num_levels(self):
        return self.max_level - self.min_level + 1

    @property
    def anchors_per_cell(self):
        return self.num_scales * len(self.aspect_ratios)

    @property
    def num_class_outputs(self):
        """Width of the class head per anchor (no background column in the
        automl convention)."""
        return self.num_classes + (1 if self.explicit_background else 0)


class SeparableConv(nn.Module):
    """automl's SeparableConv2D: a 3x3 depthwise and a 1x1 pointwise with
    one bias, on the pointwise."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.dw = nn.Conv2d(in_ch, in_ch, 3, groups=in_ch, bias=False)
        self.pw = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        x = conv_same(x, self.dw.weight, None, groups=x.shape[1])
        return F.conv2d(x, self.pw.weight.to(x.dtype),
                        self.pw.bias.to(x.dtype))


@lru_cache(maxsize=64)
def _nearest_index(in_size, out_size, device):
    """jax.image.resize 'nearest': floor((i + 0.5) * in / out) in f32.
    Cached per device, so that a captured step copies nothing. Made outside
    inference mode even when the serving step asks first: the train step's
    ``index_select`` saves it for backward, which an inference tensor
    refuses."""
    src = np.floor((np.arange(out_size, dtype=np.float32) + 0.5) * in_size
                   / out_size).astype(np.int64)
    with torch.inference_mode(False):
        return torch.from_numpy(src).to(device)


def upsample_nearest(x, h, w):
    """NCHW ``x`` resized up to (h, w) as jax.image.resize 'nearest'."""
    x = torch.index_select(x, 2, _nearest_index(x.shape[2], h, x.device))
    return torch.index_select(x, 3, _nearest_index(x.shape[3], w, x.device))


class FNode(nn.Module):
    """One BiFPN fusion node: an optional 1x1 conv + BN projection of one
    raw input ("resample"), the sum (or fast-attention sum) of the inputs,
    relu6, a separable conv with bias, BatchNorm."""

    def __init__(self, in_channels, features, resample_input=-1,
                 weight_method='sum'):
        super().__init__()
        self.resample_input = resample_input
        self.weight_method = weight_method
        if resample_input >= 0:
            self.resample = ConvBNReLU6(in_channels[resample_input],
                                        features, 1, use_relu=False)
        if weight_method == 'fastattn':
            self.WSM = nn.Parameter(torch.ones(len(in_channels)))
        elif weight_method != 'sum':
            raise ValueError('unknown fpn_weight_method {!r}'.format(
                weight_method))
        self.conv = SeparableConv(features, features)
        self.bn = make_bn(features)

    def forward(self, inputs):
        xs = list(inputs)
        if self.resample_input >= 0:
            xs[self.resample_input] = self.resample(xs[self.resample_input])
        if self.weight_method == 'fastattn':
            w = torch.relu(self.WSM)
            w = (w / (w.sum() + 1e-4)).to(xs[0].dtype)
            xs = [w[i] * x for i, x in enumerate(xs)]
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        return batch_norm(self.conv(relu6(y)), self.bn)


class BiFPN(nn.Module):
    """One BiFPN cell over P3..P7 (``in_channels`` of the five inputs).
    In the first cell the raw backbone taps (C3, C4, C5) are projected
    inside the nodes that read them."""

    # (inputs, index of the input to project in the first cell) per node,
    # inputs named: p3..p7 the cell's inputs, p6td..p4td the top-down
    # nodes, p3out..p7out the outputs
    NODES = ((('p6', 'p7'), -1),
             (('p5', 'p6td'), 0),
             (('p4', 'p5td'), 0),
             (('p3', 'p4td'), 0),
             (('p4', 'p4td', 'p3out'), 0),
             (('p5', 'p5td', 'p4out'), 0),
             (('p6', 'p6td', 'p5out'), -1),
             (('p7', 'p6out'), -1))
    OUTPUTS = ('p6td', 'p5td', 'p4td', 'p3out', 'p4out', 'p5out', 'p6out',
               'p7out')

    def __init__(self, in_channels, channels, first_cell=False,
                 weight_method='sum'):
        super().__init__()
        widths = dict(zip(('p3', 'p4', 'p5', 'p6', 'p7'), in_channels))
        for k, (names, resample) in enumerate(self.NODES):
            resample = resample if first_cell else -1
            setattr(self, 'fnode{}'.format(k),
                    FNode([widths.get(n, channels) for n in names], channels,
                          resample, weight_method))

    def forward(self, feats):
        level = dict(zip(('p3', 'p4', 'p5', 'p6', 'p7'), feats))
        out = dict(level)
        for k, (names, _) in enumerate(self.NODES):
            target = level[names[0]].shape[2:]
            inputs = [out[n] for n in names]
            if k < 4:
                # top-down: the coarser level, upsampled to this one
                inputs[1] = upsample_nearest(inputs[1], *target)
            else:
                # bottom-up: the finer output, max-pooled to this level
                inputs[-1] = max_pool_same(inputs[-1])
            out[self.OUTPUTS[k]] = getattr(self, 'fnode{}'.format(k))(inputs)
        return [out[n] for n in ('p3out', 'p4out', 'p5out', 'p6out',
                                 'p7out')]


class Head(nn.Module):
    """Separable-conv head: convs shared by every level, a BatchNorm per
    level (``bn{r}_l{level}``), relu6 after each, a separable predict
    layer. With ``copies=2`` it is the JAX package's ``_DualHead``: the
    class and box heads as one stack twice as wide, whose input is the
    level twice over and whose weights ``fuse_dual_head_params`` makes
    block-diagonal."""

    def __init__(self, out_features, repeats, channels, num_levels,
                 copies=1):
        super().__init__()
        self.repeats = repeats
        self.copies = copies
        width = channels * copies
        for r in range(repeats):
            setattr(self, 'sep{}'.format(r), SeparableConv(width, width))
        self.predict = SeparableConv(width, out_features)
        for level in range(num_levels):
            for r in range(repeats):
                setattr(self, 'bn{}_l{}'.format(r, level), make_bn(width))

    def forward(self, feats):
        outputs = []
        for level, x in enumerate(feats):
            if self.copies > 1:
                x = torch.cat([x] * self.copies, dim=1)
            for r in range(self.repeats):
                x = getattr(self, 'sep{}'.format(r))(x)
                x = relu6(batch_norm(x, getattr(self, 'bn{}_l{}'.format(
                    r, level))))
            outputs.append(self.predict(x))
        return outputs


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {key: _tree_to_numpy(value) for key, value in tree.items()}
    return np.asarray(tree)


# copied from watsor_tpu/models/efficientdet.py:316-367 (that module
# imports jax; the function is numpy)
def fuse_dual_head_params(variables, cfg: EfficientDetConfig):
    """Map standard two-head variables into the fused (``copies=2``) head
    layout: depthwise kernels (3, 3, 1, C) concatenate along the channel
    axis; pointwise kernels become block-diagonal with the box block
    offset on both axes; per-level BN params and stats concatenate. The
    predict stage maps cls to the first columns and box to the rest."""
    cat = np.concatenate

    def _dw(cls_k, box_k):
        return {'kernel': cat([cls_k['kernel'], box_k['kernel']], axis=-1)}

    def _pw_diag(cls_k, box_k):
        ck, bk = cls_k['kernel'], box_k['kernel']
        c_in, c_out = ck.shape[2], ck.shape[3]
        b_in, b_out = bk.shape[2], bk.shape[3]
        k = np.zeros((1, 1, c_in + b_in, c_out + b_out), ck.dtype)
        k[:, :, :c_in, :c_out] = ck
        k[:, :, c_in:, c_out:] = bk
        out = {'kernel': k}
        if 'bias' in cls_k:
            out['bias'] = cat([cls_k['bias'], box_k['bias']])
        return out

    def _fuse_tree(cls_t, box_t):
        fused = {}
        for name in cls_t:
            if name.startswith('sep') or name == 'predict':
                fused[name] = {'dw': _dw(cls_t[name]['dw'],
                                         box_t[name]['dw']),
                               'pw': _pw_diag(cls_t[name]['pw'],
                                              box_t[name]['pw'])}
            else:   # bn{r}_l{level}: per-channel vectors
                fused[name] = {k: cat([cls_t[name][k], box_t[name][k]])
                               for k in cls_t[name]}
        return fused

    out = {}
    for coll, tree in variables.items():
        tree = dict(tree)
        if 'cls_head' in tree and 'box_head' in tree:
            cls_t = _tree_to_numpy(tree.pop('cls_head'))
            box_t = _tree_to_numpy(tree.pop('box_head'))
            tree['dual_head'] = _fuse_tree(cls_t, box_t)
        out[coll] = tree
    return out


class EfficientDet(nn.Module):
    """images [B, S, S, 3] NHWC -> (box_enc [B, A, 4], logits [B, A,
    num_class_outputs]) in the activation dtype."""

    def __init__(self, config: EfficientDetConfig = EfficientDetConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.num_levels != 5:
            raise ValueError('the BiFPN runs levels P3..P7, not P{}..P{}'
                             .format(cfg.min_level, cfg.max_level))
        fpn = cfg.fpn_channels
        self.backbone = EfficientNetLite(cfg.variant)
        c3, c4, c5 = self.backbone.out_channels
        # P6 = pool(1x1 conv + BN of C5); P7 = pool(P6), which has no
        # weights (automl's resample_p6 / resample_p7)
        self.resample_p6 = ConvBNReLU6(c5, fpn, 1, use_relu=False)
        in_channels = (c3, c4, c5, fpn, fpn)
        for r in range(cfg.fpn_repeats):
            setattr(self, 'bifpn{}'.format(r),
                    BiFPN(in_channels, fpn, first_cell=r == 0,
                          weight_method=cfg.fpn_weight_method))
            in_channels = (fpn,) * 5
        self.cls_features = cfg.anchors_per_cell * cfg.num_class_outputs
        box_features = cfg.anchors_per_cell * 4
        if cfg.fused_heads:
            self.dual_head = Head(self.cls_features + box_features,
                                  cfg.head_repeats, fpn, 5, copies=2)
        else:
            self.cls_head = Head(self.cls_features, cfg.head_repeats, fpn, 5)
            self.box_head = Head(box_features, cfg.head_repeats, fpn, 5)
        # every BatchNorm of the family has flax momentum 0.99 (torch's
        # 0.01), where the SSD families' is 0.997; only training reads it
        for module in self.modules():
            if isinstance(module, nn.BatchNorm2d):
                module.momentum = 1.0 - EFFDET_BN_MOMENTUM

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)       # NCHW view of NHWC storage
        return self.heads(self.fpn(*self.backbone(x)))

    def fpn(self, c3, c4, c5):
        """The BiFPN stack over the backbone's taps: P6 and P7 from C5,
        then the cells -> [P3 .. P7] (NCHW views)."""
        p6 = max_pool_same(self.resample_p6(c5))
        feats = [c3, c4, c5, p6, max_pool_same(p6)]
        for r in range(self.config.fpn_repeats):
            feats = getattr(self, 'bifpn{}'.format(r))(feats)
        return feats

    def heads(self, feats):
        """The class and box heads over [P3 .. P7] -> (box_enc [B, A, 4],
        logits [B, A, num_class_outputs]) in the activation dtype."""
        cfg = self.config
        if cfg.fused_heads:
            outs = self.dual_head(feats)
            cls_out = [y[:, :self.cls_features] for y in outs]
            box_out = [y[:, self.cls_features:] for y in outs]
        else:
            cls_out = self.cls_head(feats)
            box_out = self.box_head(feats)
        B = feats[0].shape[0]
        num_cls = cfg.num_class_outputs
        boxes = torch.cat([b.permute(0, 2, 3, 1).reshape(B, -1, 4)
                           for b in box_out], dim=1)
        logits = torch.cat([c.permute(0, 2, 3, 1).reshape(B, -1, num_cls)
                            for c in cls_out], dim=1)
        return boxes, logits


def effdet_feature_shapes(cfg: EfficientDetConfig):
    return pyramid_shapes(cfg.input_size, cfg.min_level, cfg.max_level)


def effdet_anchors(cfg: EfficientDetConfig) -> np.ndarray:
    """Octave-scaled anchors for P3..P7 (the EfficientDet generator:
    base size = anchor_scale * stride, 3 octave scales per level)."""
    return multilevel_anchors(cfg.input_size, effdet_feature_shapes(cfg),
                              cfg.anchor_scale, cfg.num_scales,
                              cfg.aspect_ratios)


def normalize_effdet(x, cfg):
    """[0, 255] -> (x - mean_rgb) / stddev_rgb in ``cfg.dtype``, the
    family's input normalization (serving and training)."""
    return ((x.float() - cfg.mean_rgb) / cfg.stddev_rgb).to(cfg.dtype)


def build_effdet(config: EfficientDetConfig = EfficientDetConfig(),
                 variables=None, seed=0, anchors=None,
                 device=None) -> Detector:
    """Build the model on ``device`` (None: the current CUDA device; pass
    'cpu' for the CPU), adopting ``variables`` (a flax-layout tree of numpy
    arrays, always in the two-head layout) or, without them, initializing
    from ``seed``. The same Detector contract as models/ssd.build_detector;
    ``raw_apply`` gives f32 outputs, while the detect step ranks the
    union on the logits in the activation dtype, as the JAX step does."""
    cfg = config
    device = resolve_device(device)
    if variables is not None and cfg.fused_heads and \
            'cls_head' in variables.get('params', {}):
        variables = fuse_dual_head_params(variables, cfg)
    model, variables = place_model(EfficientDet(cfg), variables, seed,
                                   device, cfg.dtype)
    anchors = check_anchors(anchors, effdet_anchors(cfg))
    anchors_dev = torch.from_numpy(anchors).to(device)

    def raw_native(images_f):
        return model(images_f.to(cfg.dtype))

    def raw_apply(images_f):
        box_enc, logits = raw_native(images_f)
        return box_enc.float(), logits.float()

    detect_batch = make_detect_batch(
        cfg, anchors_dev, raw_native,
        lambda x: normalize_effdet(x, cfg),
        background_offset=1 if cfg.explicit_background else 0)
    return Detector(model, cfg, variables, anchors, device, detect_batch,
                    raw_apply, lambda device: build_effdet(
                        cfg, variables, anchors=anchors, device=device))
