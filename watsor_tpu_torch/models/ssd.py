"""SSD meta-architecture and the fused uint8-in -> detections-out step
(counterpart of watsor_tpu/models/ssd.py).

``SSD.forward`` takes NHWC images and returns the raw head outputs
``box_enc [B, A, 4]`` and ``logits [B, A, num_classes + 1]`` (column 0 =
background), both f32. The heads' NCHW outputs are permuted to NHWC before
the reshape, so anchors line up as in the flax model.
"""

import functools
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

from watsor_tpu_torch.models.mobilenet_v2 import (ConvBNReLU6,
                                                  MobileNetV2Backbone,
                                                  cast_convs, conv_same)
from watsor_tpu_torch.ops.anchors import (AnchorSpec, anchors_per_location,
                                          ssd300_feature_shapes, ssd_anchors)
from watsor_tpu_torch.ops.boxes import decode_boxes
from watsor_tpu_torch.ops.nms import (FUSED_SUPPRESSION, PER_CLASS_MODES,
                                      batched_class_aware_nms,
                                      batched_class_aware_nms_fused_late)
from watsor_tpu_torch.ops.preprocess import normalize_images, resize_bilinear


class SSDConfig(NamedTuple):
    """The JAX package's SSDConfig for its one ported family: the plain
    (non-Lite) SSD on a width-1.0 MobileNetV2."""

    num_classes: int = 90          # foreground classes (COCO)
    input_size: int = 300
    head_kernel: int = 3
    extra_features: Tuple[int, ...] = (512, 256, 256, 128)
    anchor_spec: AnchorSpec = AnchorSpec()
    box_coder_scales: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    iou_threshold: float = 0.6
    score_threshold: float = 0.005
    max_detections: int = 100
    nms_mode: str = 'fused'
    # restrict post-processing to these 1-based labels (None = all)
    active_labels: Any = None
    dtype: Any = torch.bfloat16


def check_supported(cfg: SSDConfig):
    """Raise for an unknown NMS mode."""
    if cfg.nms_mode not in FUSED_SUPPRESSION and \
            cfg.nms_mode not in PER_CLASS_MODES:
        raise ValueError('unknown nms mode {!r}; one of {}'.format(
            cfg.nms_mode, sorted(FUSED_SUPPRESSION) + list(PER_CLASS_MODES)))


class SSD(nn.Module):
    """MobileNetV2 feature extractor + extras + box/class conv heads."""

    def __init__(self, config: SSDConfig = SSDConfig()):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        self.backbone = MobileNetV2Backbone()
        channels = [self.backbone.block13_expand.conv.out_channels,
                    self.backbone.head.conv.out_channels]
        x_ch = channels[-1]
        for i, ch in enumerate(cfg.extra_features):
            setattr(self, 'extra{}_pw'.format(i),
                    ConvBNReLU6(x_ch, ch // 2, 1))
            setattr(self, 'extra{}'.format(i),
                    ConvBNReLU6(ch // 2, ch, 3, stride=2))
            x_ch = ch
            channels.append(ch)
        npl = anchors_per_location(cfg.anchor_spec)
        if len(channels) != len(npl):
            raise ValueError('{} feature maps for {} anchor layers'.format(
                len(channels), len(npl)))
        k = cfg.head_kernel
        for i, (ch, n) in enumerate(zip(channels, npl)):
            setattr(self, 'box_head{}'.format(i), nn.Conv2d(ch, n * 4, k))
            setattr(self, 'cls_head{}'.format(i),
                    nn.Conv2d(ch, n * (cfg.num_classes + 1), k))
        self.num_features = len(channels)

    def features(self, x):
        c4, c5 = self.backbone(x)
        feats = [c4, c5]
        for i in range(len(self.config.extra_features)):
            x = getattr(self, 'extra{}'.format(i))(
                getattr(self, 'extra{}_pw'.format(i))(feats[-1]))
            feats.append(x)
        return feats

    def forward(self, images):
        """images [B, S, S, 3] NHWC float -> (box_enc, logits), f32."""
        x = images.permute(0, 3, 1, 2)       # NCHW view of NHWC storage
        heads = []
        for i in range(self.num_features):
            box = getattr(self, 'box_head{}'.format(i))
            cls = getattr(self, 'cls_head{}'.format(i))
            heads.append(((box.weight, box.bias), (cls.weight, cls.bias)))
        return apply_heads(self.features(x), heads,
                           self.config.num_classes + 1)


def apply_heads(features, heads, num_cls):
    """Run the ((box weight, bias), (cls weight, bias)) conv heads over
    NCHW features and concatenate the anchors in the flax (NHWC) order."""
    box_out, cls_out = [], []
    for feat, (box_head, cls_head) in zip(features, heads):
        B = feat.shape[0]
        b = conv_same(feat, *box_head)
        c = conv_same(feat, *cls_head)
        box_out.append(b.permute(0, 2, 3, 1).reshape(B, -1, 4))
        cls_out.append(c.permute(0, 2, 3, 1).reshape(B, -1, num_cls))
    return (torch.cat(box_out, dim=1).float(),
            torch.cat(cls_out, dim=1).float())


def anchors_for(cfg: SSDConfig) -> np.ndarray:
    return ssd_anchors(ssd300_feature_shapes(cfg.input_size),
                       cfg.anchor_spec)


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


def make_detect_batch(cfg, anchors_dev, raw_apply, normalize,
                      background_offset=1):
    """The one fused uint8-in -> detections-out step: device resize ->
    ``normalize`` -> ``raw_apply`` -> active-label slice -> NMS -> 1-based
    label remap. The fused modes decode and take the f32 sigmoid on the
    candidate union only; the classic per-class modes decode every anchor
    in f32 and take the f32 sigmoid of every watched column."""
    check_supported(cfg)
    active = active_label_array(cfg, anchors_dev.device)
    suppression = FUSED_SUPPRESSION.get(cfg.nms_mode)

    @torch.inference_mode()
    def detect_batch(images_u8):
        x = resize_bilinear(images_u8, cfg.input_size, cfg.input_size)
        box_enc, logits = raw_apply(normalize(x))
        if active is not None:
            cls_logits = logits[..., (active - 1 + background_offset).long()]
        else:
            cls_logits = logits[..., background_offset:]
        if suppression is not None:
            b, s, c, v = batched_class_aware_nms_fused_late(
                box_enc, cls_logits, anchors_dev,
                scales=tuple(cfg.box_coder_scales),
                iou_threshold=cfg.iou_threshold,
                score_threshold=cfg.score_threshold,
                max_detections=cfg.max_detections,
                suppression=suppression)
        else:
            boxes = decode_boxes(box_enc.float(), anchors_dev,
                                 scales=tuple(cfg.box_coder_scales))
            scores = torch.sigmoid(cls_logits.float())
            b, s, c, v = batched_class_aware_nms(
                boxes, scores, iou_threshold=cfg.iou_threshold,
                score_threshold=cfg.score_threshold,
                max_detections=cfg.max_detections, mode=cfg.nms_mode)
        if active is not None:
            c = torch.where(c > 0, active[(c - 1).clamp_min(0).long()], 0)
        return DetectionsBatch(b.float(), s.float(), c, v)

    return detect_batch


def build_detector(config: SSDConfig = SSDConfig(), variables=None, seed=0,
                   anchors=None, device='cpu') -> Detector:
    """Build the model on ``device``, adopting ``variables`` (a flax-layout
    tree of numpy arrays) or, without them, initializing from ``seed``.

    ``anchors``: optional [A, 4] override (TFLite conversions carry the
    exact grid of the source graph)."""
    from watsor_tpu_torch.models.weights import (export_variables,
                                                 init_weights,
                                                 load_variables)

    cfg = config
    device = torch.device(device)
    model = SSD(cfg)
    if variables is None:
        init_weights(model, torch.Generator().manual_seed(seed))
        variables = export_variables(model)
    else:
        load_variables(model, variables)
    expected = anchors_for(cfg)
    if anchors is None:
        anchors = expected
    else:
        anchors = np.asarray(anchors, np.float32)
        if anchors.shape != expected.shape:
            raise ValueError(
                'anchor override shape {} does not match the head geometry '
                '{}'.format(anchors.shape, expected.shape))
    model = cast_convs(model.eval().to(device), cfg.dtype)
    model = model.to(memory_format=torch.channels_last)
    anchors_dev = torch.from_numpy(anchors).to(device)

    def raw_apply(images_f):
        return model(images_f.to(cfg.dtype))

    detect_batch = make_detect_batch(
        cfg, anchors_dev, raw_apply,
        functools.partial(normalize_images, dtype=cfg.dtype))
    return Detector(model, cfg, variables, anchors, device, detect_batch,
                    raw_apply)
