"""Int8-activation SSD-MobileNetV2 inference (counterpart of
watsor_tpu/models/ssd_int8.py).

    detector  = build_detector(cfg, variables=...)      # float
    qdetector = build_int8_detector(detector, calibration_images)

- weights: per-output-channel symmetric int8, BatchNorm folded in;
- activations: per-tensor symmetric int8, their scales calibrated by
  running the float model over calibration frames with forward hooks;
- the box and class heads stay float; decode and NMS are unchanged.

The walk runs NHWC int8 tensors. Every convolution sums int8 products
exactly, as XLA's int32 convolutions do: the card has no integer
convolution, so a unit convolves in f32 while its taps (kh * kw * in /
groups) keep the sum below 2^24 (at most 1040 taps of 127 * 127) and in
f64 beyond, and converts the exact sum to f32 once. The pointwise units
take the formulation that ``WATSOR_INT8_POINTWISE`` names when the
detector is built: ``conv`` (the default) requantizes with the divide
``round(y / out_scale)``; ``pallas`` runs
ops/int8_matmul.int8_matmul_requant (the CUDA kernel on the card) with
its folded ``round(y * inv)``. ``dot`` (XLA's dot_general in the JAX
package) sums the same products exactly, so here it is the ``conv`` walk.
"""

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from watsor_tpu_torch.models.mobilenet_v2 import TAP_BLOCK, block_plan, \
    conv_same
from watsor_tpu_torch.models.quantize import _quantize_kernel
from watsor_tpu_torch.models.ssd import apply_heads, make_detect_batch
from watsor_tpu_torch.models.ssd_fused import fold_unit
from watsor_tpu_torch.models.weights import hwio_to_oihw
from watsor_tpu_torch.ops.int8_matmul import int8_matmul_requant
from watsor_tpu_torch.ops.preprocess import normalize_images, resize_bilinear

POINTWISE_MODES = ('conv', 'dot', 'pallas')
# an f32 sum of int8 products is exact while taps * 127^2 < 2^24
EXACT_F32_TAPS = 1040


class QUnit(NamedTuple):
    """One folded, quantized conv unit."""

    kernel: Any       # int8 [kh, kw, in/groups, out] (the JAX layout)
    wscale: Any       # float32 [out]
    bias: Any         # float32 [out]
    out_scale: Any    # np.float32: int8 quantum of this unit's OUTPUT
    weight: Any       # the kernel as OIHW f32, or f64 past EXACT_F32_TAPS


def _unit_paths(cfg):
    """Every ConvBNRelu6 unit path in forward order (backbone + extras)."""
    paths = [('backbone', 'stem')]
    for index, expand, _, _ in block_plan():
        if index == TAP_BLOCK:
            paths += [('backbone', 'block13_expand'),
                      ('backbone', 'block13_depthwise'),
                      ('backbone', 'block13_project')]
            continue
        block = 'block{}'.format(index)
        if expand != 1:
            paths.append(('backbone', block, 'expand'))
        paths += [('backbone', block, 'depthwise'),
                  ('backbone', block, 'project')]
    paths.append(('backbone', 'head'))
    for i in range(len(cfg.extra_features)):
        paths += [('extra{}_pw'.format(i),), ('extra{}'.format(i),)]
    return paths


def _calibrated_paths(cfg):
    """The module outputs the walk reads: every unit and every block."""
    blocks = [('backbone', 'block{}'.format(index))
              for index, _, _, _ in block_plan() if index != TAP_BLOCK]
    return _unit_paths(cfg) + blocks


def _tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def calibrate(detector, images_u8, batch_limit=8):
    """Run the float model once over ``images_u8[:batch_limit]`` with
    forward hooks; returns {path tuple: f32 absmax of the module's output}
    for every unit and every MobileNetV2 block, under the flax paths."""
    cfg = detector.config
    wanted = set(_calibrated_paths(cfg))
    maxima = {}
    handles = []
    for name, module in detector.model.named_modules():
        path = tuple(name.split('.'))
        if path in wanted:
            handles.append(module.register_forward_hook(
                lambda module, inputs, out, path=path: maxima.__setitem__(
                    path, out.float().abs().amax())))
    try:
        with torch.inference_mode():
            images = torch.as_tensor(np.asarray(images_u8[:batch_limit]))
            x = resize_bilinear(images.to(detector.device), cfg.input_size,
                                cfg.input_size)
            detector.model(normalize_images(x, dtype=cfg.dtype))
    finally:
        for handle in handles:
            handle.remove()
    return {path: float(value) for path, value in maxima.items()}


def build_pack(variables, absmax, cfg, device='cpu'):
    """Folded int8 weight pack + per-unit output scales from calibration
    (``absmax``: {path tuple: float}, as ``calibrate`` returns it)."""
    params = variables['params']
    stats = variables['batch_stats']
    device = torch.device(device)

    def tensor(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    pack = {}
    for path in _unit_paths(cfg):
        kernel, bias = fold_unit(_tree_get(params, path),
                                 _tree_get(stats, path))
        q, wscale = _quantize_kernel(kernel)
        out_absmax = absmax.get(path)
        if out_absmax is None or out_absmax == 0.0:
            out_absmax = 6.0          # relu6 bound as a safe default
        taps = q.shape[0] * q.shape[1] * q.shape[2]
        pack['/'.join(path)] = QUnit(
            tensor(q), tensor(wscale), tensor(bias.astype(np.float32)),
            np.float32(out_absmax / 127.0),
            tensor(hwio_to_oihw(q), torch.float32 if taps <= EXACT_F32_TAPS
                   else torch.float64))
    # block outputs (post-residual) define the NEXT block's input scale
    pack['__scales__'] = {'/'.join(path): np.float32(max(value, 1e-6) / 127.0)
                          for path, value in absmax.items()}
    return pack


def _pointwise_mode():
    """WATSOR_INT8_POINTWISE: the formulation of the int8 1x1 units,
    ``conv`` (default), ``dot`` or ``pallas``."""
    mode = os.environ.get('WATSOR_INT8_POINTWISE', 'conv')
    if mode not in POINTWISE_MODES:
        raise ValueError('WATSOR_INT8_POINTWISE must be one of {}, got {!r}'
                         .format(', '.join(POINTWISE_MODES), mode))
    return mode


def _is_pointwise(unit, strides, groups):
    kh, kw = unit.kernel.shape[:2]
    return kh == 1 and kw == 1 and strides == 1 and groups == 1


def _dequant(acc, x_scale, unit, relu6):
    """Exact sums (f32) -> acc * (x_scale * wscale) + bias, relu6."""
    y = acc * (unit.wscale * float(x_scale)) + unit.bias
    return y.clamp(0.0, 6.0) if relu6 else y


def _requant(y_f, scale):
    """round(y / scale) clipped to int8. The divisor is a device tensor: a
    CUDA division by a host number multiplies by its reciprocal, which can
    round differently."""
    divisor = torch.full((), float(scale), dtype=torch.float32,
                         device=y_f.device)
    return torch.round(y_f / divisor).clamp(-127.0, 127.0) \
        .to(torch.int8), scale


def _pointwise(x_i8, x_scale, unit, relu6, out_scale):
    """1x1 conv as an [B*H*W, K] x [K, N] int8 matmul through the kernel
    wrapper; out_scale=None returns float."""
    B, H, W, C = x_i8.shape
    y = int8_matmul_requant(x_i8.reshape(-1, C), unit.kernel.reshape(C, -1),
                            unit.wscale * float(x_scale), unit.bias,
                            out_scale=out_scale, relu6=relu6)
    return y.reshape(B, H, W, -1)


def _exact_conv(x_i8, unit, strides, groups):
    """int8 NHWC convolution -> its exact sums as contiguous f32 NHWC (TF
    'SAME'). A convolution may return NCHW storage (f64 does on the card):
    the kernel wrapper takes only contiguous rows."""
    x = x_i8.permute(0, 3, 1, 2).to(unit.weight.dtype)
    y = conv_same(x, unit.weight, None, stride=strides, groups=groups)
    return y.float().permute(0, 2, 3, 1).contiguous()


def _qconv(x_i8, x_scale, unit, strides=1, groups=1, relu6=True,
           out_scale=None, mode='conv'):
    """int8 conv + dequant/bias/act/requant epilogue -> (y_i8, y_scale).
    ``out_scale`` overrides the unit's own output quantum."""
    scale = out_scale if out_scale is not None else unit.out_scale
    if _is_pointwise(unit, strides, groups) and mode == 'pallas':
        return _pointwise(x_i8, x_scale, unit, relu6, scale), scale
    y = _dequant(_exact_conv(x_i8, unit, strides, groups), x_scale, unit,
                 relu6)
    return _requant(y, scale)


def _qconv_f(x_i8, x_scale, unit, strides=1, groups=1, relu6=True,
             mode='conv'):
    """Same conv, float output (for residual adds)."""
    if _is_pointwise(unit, strides, groups) and mode == 'pallas':
        return _pointwise(x_i8, x_scale, unit, relu6, None)
    return _dequant(_exact_conv(x_i8, unit, strides, groups), x_scale, unit,
                    relu6)


def quantized_features(pack, x_i8, x_scale, cfg, mode='conv'):
    """The int8 backbone+extras walk over NHWC int8 ``x_i8``. Returns the
    6 head feature maps as (tensor_i8, scale) pairs in pyramid order;
    ``mode`` is the pointwise formulation."""
    def unit(*path):
        return pack['/'.join(path)]
    scales = pack['__scales__']

    x, s = _qconv(x_i8, x_scale, unit('backbone', 'stem'), strides=2,
                  mode=mode)
    tap_c4 = None
    prev_features = x.shape[-1]
    for index, expand, features, strides in block_plan():
        if index == TAP_BLOCK:
            y, sy = _qconv(x, s, unit('backbone', 'block13_expand'),
                           mode=mode)
            tap_c4 = (y, sy)
            y, sy = _qconv(y, sy, unit('backbone', 'block13_depthwise'),
                           strides=strides, groups=y.shape[-1], mode=mode)
            x, s = _qconv(y, sy, unit('backbone', 'block13_project'),
                          relu6=False, mode=mode)
            prev_features = features
            continue
        block = 'block{}'.format(index)
        residual = strides == 1 and prev_features == features
        y, sy = (x, s)
        if expand != 1:
            y, sy = _qconv(y, sy, unit('backbone', block, 'expand'),
                           mode=mode)
        y, sy = _qconv(y, sy, unit('backbone', block, 'depthwise'),
                       strides=strides, groups=y.shape[-1], mode=mode)
        if residual:
            y_f = _qconv_f(y, sy, unit('backbone', block, 'project'),
                           relu6=False, mode=mode)
            y_f = y_f + x.float() * float(s)
            x, s = _requant(y_f, scales['backbone/' + block])
        else:
            x, s = _qconv(y, sy, unit('backbone', block, 'project'),
                          relu6=False, mode=mode)
        prev_features = features
    c5, s5 = _qconv(x, s, unit('backbone', 'head'), mode=mode)

    features = [tap_c4, (c5, s5)]
    y, sy = c5, s5
    for i in range(len(cfg.extra_features)):
        y, sy = _qconv(y, sy, unit('extra{}_pw'.format(i)), mode=mode)
        y, sy = _qconv(y, sy, unit('extra{}'.format(i)), strides=2,
                       mode=mode)
        features.append((y, sy))
    return features


def _in_dtype(value, dtype):
    """A host number rounded to ``dtype`` (``s.astype(dtype)``)."""
    return float(torch.tensor(float(value), dtype=torch.float32).to(dtype))


def build_int8_detector(detector, calibration_images_u8, pointwise=None,
                        absmax=None):
    """Float detector (the plain model) + calibration frames -> a Detector
    whose detect_batch runs the int8 walk (same output contract).
    ``pointwise`` overrides WATSOR_INT8_POINTWISE; ``absmax`` adopts an
    earlier calibration instead of running one."""
    cfg = detector.config
    if detector.model is None:
        raise ValueError('build_int8_detector needs the plain float model')
    mode = pointwise or _pointwise_mode()
    if mode not in POINTWISE_MODES:
        raise ValueError('unknown pointwise mode {!r}'.format(mode))
    device = detector.device
    if absmax is None:
        absmax = calibrate(detector, calibration_images_u8)
    pack = build_pack(detector.variables, absmax, cfg, device)

    # heads in the activation dtype, convolved with f32 sums: f32 operands
    # that hold the dtype-rounded values
    params = detector.variables['params']
    heads = []
    for i in range(len(cfg.extra_features) + 2):
        pair = []
        for name in ('box_head{}', 'cls_head{}'):
            p = params[name.format(i)]
            weight = torch.from_numpy(np.ascontiguousarray(hwio_to_oihw(
                np.asarray(p['kernel'], np.float32))))
            pair.append((weight.to(device, cfg.dtype).float(),
                         torch.from_numpy(np.asarray(p['bias'], np.float32))
                         .to(device)))
        heads.append(tuple(pair))
    anchors_dev = torch.from_numpy(detector.anchors).to(device)
    x_scale = np.float32(1.0 / 127.0)

    def raw_apply(images_f):
        # [-1, 1] float input -> int8 (quantum 1/127)
        x_i8 = torch.round(images_f.float() * 127.0).clamp(-127.0, 127.0) \
            .to(torch.int8)
        feats = quantized_features(pack, x_i8, x_scale, cfg, mode)
        nchw = [(f.to(cfg.dtype) * _in_dtype(s, cfg.dtype)).float()
                .permute(0, 3, 1, 2) for f, s in feats]
        return apply_heads(nchw, heads, cfg.num_classes + 1)

    # the int8 walk quantizes from f32 (no dtype cast before raw_apply)
    detect_batch = make_detect_batch(
        cfg, anchors_dev, raw_apply,
        lambda x: x.float() * (2.0 / 255.0) - 1.0)
    return detector._replace(model=None, detect_batch=detect_batch,
                             raw_apply=raw_apply)
