"""SSD anchor generation, numpy, built once at model build.

``AnchorSpec`` and ``ssd_anchors`` are copied from watsor_tpu/ops/anchors.py:
that module is numpy, but importing it runs ``watsor_tpu/ops/__init__.py``,
which imports jax. ``multilevel_anchors`` is the grid of a feature pyramid
(EfficientDet's generator and TF OD's ``multiscale_anchor_generator``),
selected for an SSD by a ``MultiscaleAnchorSpec``.
"""

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np


class AnchorSpec(NamedTuple):
    """Configuration mirroring the TF OD API ssd_anchor_generator proto."""

    num_layers: int = 6
    min_scale: float = 0.2
    max_scale: float = 0.95
    aspect_ratios: Tuple[float, ...] = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
    reduce_boxes_in_lowest_layer: bool = True
    interpolated_scale_aspect_ratio: float = 1.0
    base_anchor_size: Tuple[float, float] = (1.0, 1.0)


class MultiscaleAnchorSpec(NamedTuple):
    """TF OD's multiscale_anchor_generator proto: on each level from
    ``min_level`` to ``max_level`` (stride 2^level of the input) anchors
    of base size anchor_scale x stride x 2^(k / scales_per_octave), k <
    scales_per_octave, at each aspect ratio."""

    min_level: int = 3
    max_level: int = 7
    anchor_scale: float = 4.0
    scales_per_octave: int = 2
    aspect_ratios: Tuple[float, ...] = (1.0, 2.0, 0.5)

    @property
    def num_layers(self):
        return self.max_level - self.min_level + 1

    @property
    def per_cell(self):
        return self.scales_per_octave * len(self.aspect_ratios)


def _layer_boxes(spec, layer, scales):
    """(scale, aspect_ratio) pairs for one feature-map layer."""
    if layer == 0 and spec.reduce_boxes_in_lowest_layer:
        return [(0.1, 1.0), (scales[0], 2.0), (scales[0], 0.5)]
    pairs = [(scales[layer], a) for a in spec.aspect_ratios]
    if spec.interpolated_scale_aspect_ratio > 0:
        next_scale = scales[layer + 1] if layer + 1 < len(scales) else 1.0
        pairs.append((math.sqrt(scales[layer] * next_scale),
                      spec.interpolated_scale_aspect_ratio))
    return pairs


def _linear_scales(spec):
    return [spec.min_scale + (spec.max_scale - spec.min_scale) * k /
            (spec.num_layers - 1) for k in range(spec.num_layers)]


def anchors_per_location(spec: AnchorSpec = AnchorSpec()) -> Tuple[int, ...]:
    """Number of anchors per grid cell for each feature layer."""
    if isinstance(spec, MultiscaleAnchorSpec):
        return (spec.per_cell,) * spec.num_layers
    scales = _linear_scales(spec)
    return tuple(len(_layer_boxes(spec, k, scales))
                 for k in range(spec.num_layers))


def ssd_anchors(feature_map_shapes: Sequence[Tuple[int, int]],
                spec: AnchorSpec = AnchorSpec()) -> np.ndarray:
    """[A, 4] float32 ymin/xmin/ymax/xmax anchors; anchor-within-cell is the
    fastest-varying axis, matching the heads' channel layout."""
    if len(feature_map_shapes) != spec.num_layers:
        raise ValueError('expected {} feature maps, got {}'.format(
            spec.num_layers, len(feature_map_shapes)))
    scales = _linear_scales(spec)
    base_h, base_w = spec.base_anchor_size
    out = []
    for k, (fh, fw) in enumerate(feature_map_shapes):
        pairs = _layer_boxes(spec, k, scales)
        y = (np.arange(fh, dtype=np.float32) + 0.5) / fh
        x = (np.arange(fw, dtype=np.float32) + 0.5) / fw
        ycenter, xcenter = np.meshgrid(y, x, indexing='ij')
        heights = np.array([s / math.sqrt(a) * base_h for s, a in pairs],
                           dtype=np.float32)
        widths = np.array([s * math.sqrt(a) * base_w for s, a in pairs],
                          dtype=np.float32)
        yc = ycenter[..., None]
        xc = xcenter[..., None]
        h = heights[None, None, :]
        w = widths[None, None, :]
        boxes = np.stack([yc - 0.5 * h, xc - 0.5 * w,
                          yc + 0.5 * h, xc + 0.5 * w], axis=-1)
        out.append(boxes.reshape(-1, 4))
    return np.concatenate(out, axis=0)


def ssd300_feature_shapes(input_size: int = 300) -> Tuple[Tuple[int, int],
                                                          ...]:
    """The stride-{16,32,64,128,256,300} ladder for a square input."""
    dims = [math.ceil(input_size / 16), math.ceil(input_size / 32)]
    d = dims[-1]
    while len(dims) < 6:
        d = max(1, math.ceil(d / 2))
        dims.append(d)
    return tuple((d, d) for d in dims)


def pyramid_shapes(input_size, min_level, max_level):
    """[(side, side)] of levels ``min_level`` to ``max_level`` of a square
    input: each level halves the one before, rounding up ('SAME' stride
    2)."""
    dims = {}
    d = input_size
    for level in range(1, max_level + 1):
        d = math.ceil(d / 2)
        dims[level] = d
    return [(dims[level], dims[level])
            for level in range(min_level, max_level + 1)]


def multilevel_anchors(input_size, feature_shapes, anchor_scale, num_scales,
                       aspect_ratios) -> np.ndarray:
    """[A, 4] float32 ymin/xmin/ymax/xmax anchors of a feature pyramid,
    normalized to the input: on a level of stride s = input_size / side,
    base = anchor_scale * s * 2^(k / num_scales) for each scale k, height
    base / sqrt(a) and width base * sqrt(a) for each aspect ratio a,
    centred at ((i + 0.5) s, (j + 0.5) s); the anchor within a cell
    fastest, scale-major."""
    out = []
    for fh, fw in feature_shapes:
        stride = input_size / fh
        y = (np.arange(fh, dtype=np.float32) + 0.5) * stride / input_size
        x = (np.arange(fw, dtype=np.float32) + 0.5) * stride / input_size
        ycenter, xcenter = np.meshgrid(y, x, indexing='ij')
        sizes = []
        for octave in range(num_scales):
            base = anchor_scale * stride * (2 ** (octave / num_scales))
            for aspect in aspect_ratios:
                h = base / math.sqrt(aspect) / input_size
                w = base * math.sqrt(aspect) / input_size
                sizes.append((h, w))
        heights = np.array([s[0] for s in sizes], np.float32)
        widths = np.array([s[1] for s in sizes], np.float32)
        yc = ycenter[..., None]
        xc = xcenter[..., None]
        h = heights[None, None, :]
        w = widths[None, None, :]
        boxes = np.stack([yc - 0.5 * h, xc - 0.5 * w,
                          yc + 0.5 * h, xc + 0.5 * w], axis=-1)
        out.append(boxes.reshape(-1, 4))
    return np.concatenate(out, axis=0)

