"""SSD meta-architecture and the fused uint8-in -> detections-out step
(counterpart of watsor_tpu/models/ssd.py).

``SSD.forward`` takes NHWC images and returns the raw head outputs
``box_enc [B, A, 4]`` and ``logits [B, A, num_classes + 1]`` (column 0 =
background), both f32 (f64 for an f64 model). The heads' NCHW outputs are
permuted to NHWC before the reshape, so anchors line up as in the flax
model. The three SSD families of the JAX package: MobileNetV2 (at any
width), MobileNetV1 and InceptionV2 backbones, each plain or SSDLite
(separable extras and heads); and TF OD's RetinaNet form of the SSD: a
ResNet-50 v1 backbone (models/resnet_v1.py), an FPN over P3 to P7 in place
of the extras and a weight-shared predictor in place of the per-layer
heads (models/fpn.py), anchors of a ``MultiscaleAnchorSpec``, inputs less
the channel means in place of [-1, 1].

The forward opens the program's spans (runtime/spans.py) ``model.backbone``,
``model.fpn`` (``model.extras`` without the FPN; counts ``levels``) and
``model.heads`` (counts ``anchors`` and ``levels``), each stamped on the
input's device.
"""

import functools
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

from watsor_tpu_torch.models.fpn import (FPN, FPN_DEPTH, TOWER_LAYERS,
                                         WeightSharedTower)
from watsor_tpu_torch.models.mobilenet_v2 import (ConvBNReLU6,
                                                  MobileNetV2Backbone,
                                                  cast_convs, conv_same)
from watsor_tpu_torch.models.resnet_v1 import CHANNEL_MEANS
from watsor_tpu_torch.models.weights import (export_variables, init_weights,
                                             load_variables)
from watsor_tpu_torch.ops.anchors import (AnchorSpec, MultiscaleAnchorSpec,
                                          anchors_per_location,
                                          multilevel_anchors, pyramid_shapes,
                                          ssd300_feature_shapes, ssd_anchors)
from watsor_tpu_torch.ops.boxes import decode_boxes
from watsor_tpu_torch.ops.nms import (FUSED_SUPPRESSION, PER_CLASS_MODES,
                                      batched_class_aware_nms,
                                      batched_class_aware_nms_fused_late)
from watsor_tpu_torch.ops.preprocess import (normalize_images,
                                             resize_bilinear, subtract_means)
from watsor_tpu_torch.runtime.spans import span


BACKBONES = ('mobilenet_v2', 'mobilenet_v1', 'inception_v2', 'resnet50_v1')


class SSDConfig(NamedTuple):
    """The JAX package's SSDConfig (watsor_tpu/models/ssd.py:30-61)."""

    num_classes: int = 90          # foreground classes (COCO)
    input_size: int = 300
    backbone: str = 'mobilenet_v2'  # one of BACKBONES
    # box/class predictor conv size (public v2 checkpoints 3x3, v1 1x1)
    head_kernel: int = 3
    # SSDLite: separable 3x3 convs in the extras' second stage and in the
    # predictors
    lite: bool = False
    width_multiplier: float = 1.0  # MobileNet backbones only
    extra_features: Tuple[int, ...] = (512, 256, 256, 128)
    # a MultiscaleAnchorSpec for the resnet50_v1 backbone (its FPN's levels)
    anchor_spec: Any = AnchorSpec()
    box_coder_scales: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    iou_threshold: float = 0.6
    score_threshold: float = 0.005
    max_detections: int = 100
    nms_mode: str = 'fused'
    # restrict post-processing to these 1-based labels (None = all)
    active_labels: Any = None
    dtype: Any = torch.bfloat16


def check_supported(cfg):
    """Raise for an unknown NMS mode (or, for an SSD, backbone, or a
    feature pyramid or predictor its backbone cannot feed)."""
    backbone = getattr(cfg, 'backbone', BACKBONES[0])
    if backbone not in BACKBONES:
        raise ValueError('unknown backbone {!r}; one of {}'.format(
            cfg.backbone, list(BACKBONES)))
    spec = getattr(cfg, 'anchor_spec', None)
    pyramid = isinstance(spec, MultiscaleAnchorSpec)
    if pyramid != has_fpn(cfg) or (pyramid and cfg.lite):
        raise ValueError('the resnet50_v1 backbone, and no other, takes a '
                         'MultiscaleAnchorSpec (its FPN\'s levels), and no '
                         'SSDLite heads')
    if pyramid and not (spec.min_level == 3 and spec.max_level >= 5):
        raise ValueError('the FPN runs from level 3 to level 5 or above')
    if cfg.nms_mode not in FUSED_SUPPRESSION and \
            cfg.nms_mode not in PER_CLASS_MODES:
        raise ValueError('unknown nms mode {!r}; one of {}'.format(
            cfg.nms_mode, sorted(FUSED_SUPPRESSION) + list(PER_CLASS_MODES)))


def has_fpn(cfg):
    """The RetinaNet form: the FPN and the weight-shared predictor in place
    of the extras and the per-layer heads, the channel means subtracted."""
    return getattr(cfg, 'backbone', None) == 'resnet50_v1'


def make_backbone(cfg: SSDConfig):
    """The configured feature extractor (watsor_tpu/models/ssd.py:77-87)."""
    if cfg.backbone == 'mobilenet_v1':
        from watsor_tpu_torch.models.mobilenet_v1 import MobileNetV1Backbone
        return MobileNetV1Backbone(cfg.width_multiplier)
    if cfg.backbone == 'inception_v2':
        from watsor_tpu_torch.models.inception_v2 import InceptionV2Backbone
        return InceptionV2Backbone()
    if cfg.backbone == 'resnet50_v1':
        from watsor_tpu_torch.models.resnet_v1 import ResNet50V1
        return ResNet50V1()
    return MobileNetV2Backbone(cfg.width_multiplier)


class SSD(nn.Module):
    """Feature extractor + extras (or FPN) + box/class conv heads (or the
    weight-shared predictor)."""

    def __init__(self, config: SSDConfig = SSDConfig()):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        self.backbone = make_backbone(cfg)
        npl = anchors_per_location(cfg.anchor_spec)
        if has_fpn(cfg):
            self.fpn = FPN(self.backbone.out_channels, FPN_DEPTH,
                           cfg.anchor_spec.max_level)
            self.num_features = len(npl)
            for kind, width in (('box', 4), ('cls', cfg.num_classes + 1)):
                setattr(self, kind + '_tower', WeightSharedTower(
                    FPN_DEPTH, npl[0] * width, TOWER_LAYERS,
                    self.num_features))
            return
        channels = self._extras(cfg)
        if len(channels) != len(npl):
            raise ValueError('{} feature maps for {} anchor layers'.format(
                len(channels), len(npl)))
        k = cfg.head_kernel
        for i, (ch, n) in enumerate(zip(channels, npl)):
            if cfg.lite:
                # SSDLite predictors: a depthwise k x k (BN, relu6) feeding
                # a 1x1 linear conv with bias
                for head in ('box', 'cls'):
                    setattr(self, '{}_head{}_dw'.format(head, i),
                            ConvBNReLU6(ch, ch, k, groups=ch))
            k_out = 1 if cfg.lite else k
            setattr(self, 'box_head{}'.format(i), nn.Conv2d(ch, n * 4, k_out))
            setattr(self, 'cls_head{}'.format(i),
                    nn.Conv2d(ch, n * (cfg.num_classes + 1), k_out))
        self.num_features = len(channels)

    def _extras(self, cfg):
        """The SSD extras' modules; returns every feature map's width."""
        channels = list(self.backbone.out_channels)
        x_ch = channels[-1]
        for i, ch in enumerate(cfg.extra_features):
            setattr(self, 'extra{}_pw'.format(i),
                    ConvBNReLU6(x_ch, ch // 2, 1))
            if cfg.lite:
                # separable 3x3 s2: depthwise + pointwise (SSDLite extras)
                setattr(self, 'extra{}_dw'.format(i),
                        ConvBNReLU6(ch // 2, ch // 2, 3, stride=2,
                                    groups=ch // 2))
                setattr(self, 'extra{}'.format(i),
                        ConvBNReLU6(ch // 2, ch, 1))
            else:
                setattr(self, 'extra{}'.format(i),
                        ConvBNReLU6(ch // 2, ch, 3, stride=2))
            x_ch = ch
            channels.append(ch)
        return channels

    def neck(self, taps):
        """The backbone's taps -> the feature maps the heads read: the FPN's
        levels, or the taps and the extras."""
        if has_fpn(self.config):
            return self.fpn(taps)
        feats = list(taps)
        for i in range(len(self.config.extra_features)):
            x = getattr(self, 'extra{}_pw'.format(i))(feats[-1])
            if self.config.lite:
                x = getattr(self, 'extra{}_dw'.format(i))(x)
            feats.append(getattr(self, 'extra{}'.format(i))(x))
        return feats

    def forward(self, images, heads=None):
        """images [B, S, S, 3] NHWC float -> (box_enc, logits), f32.
        ``heads``: {head name: head} to run in place of the module's own
        head convolutions (a split head of parallel/heads.py; not of the
        weight-shared predictor)."""
        x = images.permute(0, 3, 1, 2)       # NCHW view of NHWC storage
        device = x.device
        with span('model.backbone', device=device):
            taps = self.backbone(x)
        with span('model.fpn' if has_fpn(self.config) else 'model.extras',
                  device=device, levels=self.num_features):
            feats = self.neck(taps)
        with span('model.heads', device=device,
                  levels=self.num_features) as traced:
            out = self.predict(feats, heads)
            traced.count(anchors=out[0].shape[1])
        return out

    def predict(self, feats, heads=None):
        """The predictors over the feature maps -> (box_enc, logits)."""
        num_cls = self.config.num_classes + 1
        if has_fpn(self.config):
            if heads:
                raise ValueError('the weight-shared predictor does not split')
            return concat_levels(self.box_tower(feats),
                                 self.cls_tower(feats), num_cls)
        heads = heads or {}
        pairs, inputs = [], []
        for i, feat in enumerate(feats):
            pair = []
            for kind in ('box', 'cls'):
                name = '{}_head{}'.format(kind, i)
                conv = getattr(self, name)
                pair.append(heads.get(name, (conv.weight, conv.bias)))
            pairs.append(tuple(pair))
            if self.config.lite:
                feat = (getattr(self, 'box_head{}_dw'.format(i))(feat),
                        getattr(self, 'cls_head{}_dw'.format(i))(feat))
            inputs.append(feat)
        return apply_heads(inputs, pairs, num_cls)


def apply_heads(features, heads, num_cls):
    """Run the ((box weight, bias), (cls weight, bias)) conv heads over
    NCHW features (or (box input, cls input) pairs, as SSDLite's separate
    depthwise stages give them) and concatenate the anchors in the flax
    (NHWC) order. A head may instead be a callable (x) -> y: a head split
    over a model group (parallel/heads.py)."""
    def conv(x, head):
        return head(x) if callable(head) else conv_same(x, *head)

    box_out, cls_out = [], []
    for feat, (box_head, cls_head) in zip(features, heads):
        box_in, cls_in = feat if isinstance(feat, tuple) else (feat, feat)
        box_out.append(conv(box_in, box_head))
        cls_out.append(conv(cls_in, cls_head))
    return concat_levels(box_out, cls_out, num_cls)


def concat_levels(box_out, cls_out, num_cls):
    """The heads' NCHW outputs a level -> (box_enc [B, A, 4], logits [B, A,
    num_cls]), the anchors in the flax (NHWC) order, level by level."""
    B = box_out[0].shape[0]
    box = [b.permute(0, 2, 3, 1).reshape(B, -1, 4) for b in box_out]
    cls = [c.permute(0, 2, 3, 1).reshape(B, -1, num_cls) for c in cls_out]
    # f32 at least: f64 stays f64 (the f64 train step)
    wide = torch.promote_types(box[0].dtype, torch.float32)
    return torch.cat(box, dim=1).to(wide), torch.cat(cls, dim=1).to(wide)


def anchors_for(cfg: SSDConfig) -> np.ndarray:
    spec = cfg.anchor_spec
    if isinstance(spec, MultiscaleAnchorSpec):
        return multilevel_anchors(
            cfg.input_size, pyramid_shapes(cfg.input_size, spec.min_level,
                                           spec.max_level),
            spec.anchor_scale, spec.scales_per_octave, spec.aspect_ratios)
    return ssd_anchors(ssd300_feature_shapes(cfg.input_size),
                       cfg.anchor_spec)


def ssd_normalizer(cfg: SSDConfig):
    """[0, 255] -> the model's input in ``cfg.dtype``: less the channel
    means for the RetinaNet form, else [-1, 1]."""
    if has_fpn(cfg):
        return functools.partial(subtract_means, means=CHANNEL_MEANS,
                                 dtype=cfg.dtype)
    return functools.partial(normalize_images, dtype=cfg.dtype)


class Detector(NamedTuple):
    """A built detector: the model, its weights as a flax-layout variables
    tree of numpy arrays, and the batched detection step on ``device``."""

    model: Any                 # SSD module (None for packed walks)
    config: SSDConfig
    variables: Any             # {'params': ..., 'batch_stats': ...}
    anchors: np.ndarray
    device: torch.device
    detect_batch: Any          # (images_u8 [B, H, W, 3]) -> DetectionsBatch
    raw_apply: Any             # (images_f [B, S, S, 3]) -> (box_enc, logits)
    # (device) -> the same detector on ``device``, from these weights; the
    # SSD walks also take ``heads=`` (build_detector's)
    rebuild: Any = None


class DetectionsBatch(NamedTuple):
    boxes: torch.Tensor        # [B, N, 4] normalized ymin/xmin/ymax/xmax
    scores: torch.Tensor       # [B, N]
    classes: torch.Tensor      # [B, N] int32 1-based labels, 0 = padding
    valid: torch.Tensor        # [B] int32


def active_label_array(cfg, device=None):
    """The sorted watched-label vector (or None = all classes)."""
    if cfg.active_labels is None:
        return None
    labels = sorted(set(int(label) for label in cfg.active_labels
                        if 0 < int(label) <= cfg.num_classes))
    return torch.tensor(labels, dtype=torch.int32, device=device)


def post_nms(cfg, anchors_dev, box_enc, cls_logits):
    """The detect step's decode and NMS on the raw outputs ``box_enc``
    [B, A, 4] and ``cls_logits`` [B, A, C] (background and unwatched
    columns removed) -> (boxes, scores, classes numbered from 1 over the
    columns with 0 for padding, valid).
    The fused modes decode and take the f32 sigmoid on the candidate union
    only; the classic per-class modes decode every anchor in f32 and take
    the f32 sigmoid of every column."""
    kw = dict(iou_threshold=cfg.iou_threshold,
              score_threshold=cfg.score_threshold,
              max_detections=cfg.max_detections)
    suppression = FUSED_SUPPRESSION.get(cfg.nms_mode)
    if suppression is not None:
        return batched_class_aware_nms_fused_late(
            box_enc, cls_logits, anchors_dev,
            scales=tuple(cfg.box_coder_scales), suppression=suppression,
            **kw)
    boxes = decode_boxes(box_enc.float(), anchors_dev,
                         scales=tuple(cfg.box_coder_scales))
    return batched_class_aware_nms(boxes, torch.sigmoid(cls_logits.float()),
                                   mode=cfg.nms_mode, **kw)


def make_detect_batch(cfg, anchors_dev, raw_apply, normalize,
                      background_offset=1):
    """The one fused uint8-in -> detections-out step: device resize ->
    ``normalize`` -> ``raw_apply`` -> active-label slice -> ``post_nms``
    -> 1-based label remap."""
    check_supported(cfg)
    active = active_label_array(cfg, anchors_dev.device)

    @torch.inference_mode()
    def detect_batch(images_u8):
        x = resize_bilinear(images_u8, cfg.input_size, cfg.input_size)
        box_enc, logits = raw_apply(normalize(x))
        if active is not None:
            cls_logits = logits[..., (active - 1 + background_offset).long()]
        else:
            cls_logits = logits[..., background_offset:]
        b, s, c, v = post_nms(cfg, anchors_dev, box_enc, cls_logits)
        if active is not None:
            c = torch.where(c > 0, active[(c - 1).clamp_min(0).long()], 0)
        return DetectionsBatch(b.float(), s.float(), c, v)

    return detect_batch


def resolve_device(device=None):
    """``device`` as a torch.device; None is the current CUDA device. With
    no CUDA device visible, None raises: the port runs on the card unless
    the caller asks for the CPU, and never falls back to it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device='cpu' to "
                           "build on the CPU")
    return torch.device('cuda', torch.cuda.current_device())


def place_model(model, variables, seed, device, dtype):
    """``model`` with ``variables`` (or, without them, weights initialized
    from ``seed``), in eval mode on ``device``, convolutions in ``dtype``,
    channels last. Returns (model, its variables tree)."""
    if variables is None:
        init_weights(model, torch.Generator().manual_seed(seed))
        variables = export_variables(model)
    else:
        load_variables(model, variables)
    model = cast_convs(model.eval().to(device), dtype)
    return model.to(memory_format=torch.channels_last), variables


def check_anchors(anchors, expected):
    """The anchor override as f32, or ``expected`` without one; an
    override of another shape than the head geometry's raises."""
    if anchors is None:
        return expected
    anchors = np.asarray(anchors, np.float32)
    if anchors.shape != expected.shape:
        raise ValueError(
            'anchor override shape {} does not match the head geometry {}: '
            'the postprocess sidecar is stale or belongs to another model'
            .format(anchors.shape, expected.shape))
    return anchors


def build_detector(config: SSDConfig = SSDConfig(), variables=None, seed=0,
                   anchors=None, device=None, heads=None) -> Detector:
    """Build the model on ``device`` (None: the current CUDA device; pass
    'cpu' for the CPU), adopting ``variables`` (a flax-layout tree of numpy
    arrays) or, without them, initializing from ``seed``.

    ``anchors``: optional [A, 4] override (TFLite conversions carry the
    exact grid of the source graph). ``heads``: {head name: head} run in
    place of those head convolutions (``SSD.forward``), as the fleet's
    model axis splits them."""
    cfg = config
    device = resolve_device(device)
    model, variables = place_model(SSD(cfg), variables, seed, device,
                                   cfg.dtype)
    anchors = check_anchors(anchors, anchors_for(cfg))
    anchors_dev = torch.from_numpy(anchors).to(device)

    def raw_apply(images_f):
        return model(images_f.to(cfg.dtype), heads)

    detect_batch = make_detect_batch(cfg, anchors_dev, raw_apply,
                                     ssd_normalizer(cfg))
    return Detector(model, cfg, variables, anchors, device, detect_batch,
                    raw_apply, lambda device, heads=None: build_detector(
                        cfg, variables, anchors=anchors, device=device,
                        heads=heads))
