"""Weight quantization: per-channel symmetric int8 for conv kernels
(counterpart of watsor_tpu/models/quantize.py).

``quantize_params`` / ``dequantize_params`` round-trip a flax-layout
variables tree of numpy arrays; only 4-D conv kernels are quantized
(biases and BatchNorm parameters and statistics stay float).
``build_quantized_detector`` is the ``WATSOR_QUANTIZE=int8`` mode: the
kernels sit on the device as int8 values with per-output-channel scales,
and every step dequantizes them in the activation dtype before running the
float model.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from watsor_tpu_torch.models.weights import hwio_to_oihw


class QuantizedLeaf(NamedTuple):
    """An int8 tensor + its per-output-channel dequant scale."""

    values: Any      # int8, original shape
    scales: Any      # float32, [out_channels]


def _is_conv_kernel(name, leaf):
    return name == 'kernel' and getattr(leaf, 'ndim', 0) == 4


def _map_tree(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict, QuantizedLeaf as a leaf."""
    if isinstance(tree, dict):
        return {key: _map_tree(value, fn, path + (key,))
                for key, value in tree.items()}
    return fn(path, tree)


def _quantize_kernel(kernel):
    """Per-output-channel (last axis) symmetric int8 of one 4-D kernel."""
    kernel = np.asarray(kernel, np.float32)
    absmax = np.abs(kernel).reshape(-1, kernel.shape[-1]).max(axis=0)
    scales = (absmax / 127.0).astype(np.float32)
    scales = np.where(scales == 0.0, 1.0, scales)
    q = np.clip(np.round(kernel / scales), -127, 127).astype(np.int8)
    return QuantizedLeaf(q, scales)


def quantize_params(params):
    """variables tree -> tree with conv kernels replaced by QuantizedLeaf
    (numpy int8 values, f32 scales)."""
    def quantize(path, leaf):
        if isinstance(leaf, QuantizedLeaf) or \
                not _is_conv_kernel(path[-1] if path else '', leaf):
            return leaf
        return _quantize_kernel(leaf)

    return _map_tree(params, quantize)


def dequantize_params(params, dtype=torch.bfloat16):
    """Inverse transform: each QuantizedLeaf becomes
    ``values.to(dtype) * scales.to(dtype)`` (tensors or numpy arrays)."""
    def dequantize(path, leaf):
        if isinstance(leaf, QuantizedLeaf):
            values = torch.as_tensor(leaf.values)
            scales = torch.as_tensor(leaf.scales, device=values.device)
            return values.to(dtype) * scales.to(dtype)
        return leaf

    return _map_tree(params, dequantize)


def quantization_error(params):
    """Max relative error per quantized kernel (diagnostics)."""
    errors = {}

    def visit(path, leaf):
        if _is_conv_kernel(path[-1] if path else '', leaf):
            quantized = _quantize_kernel(leaf)
            restored = np.asarray(quantized.values, np.float32) * \
                np.asarray(quantized.scales)
            kernel = np.asarray(leaf, np.float32)
            denom = np.abs(kernel).max() or 1.0
            errors['/'.join(path)] = float(np.abs(restored - kernel).max() /
                                           denom)
        return leaf

    _map_tree(params, visit)
    return errors


def build_quantized_detector(config=None, variables=None, seed=0,
                             anchors=None, device='cpu'):
    """SSD detector whose conv kernels sit on ``device`` as int8 values and
    scales (OIHW, scales along O); each step dequantizes them in the
    activation dtype, as the JAX step does inside its jit, and runs the
    float model on them. Detector.variables is the quantized tree."""
    from torch.func import functional_call

    from watsor_tpu_torch.models.mobilenet_v2 import ConvBNReLU6
    from watsor_tpu_torch.models.ssd import (SSDConfig, build_detector,
                                             make_detect_batch)
    from watsor_tpu_torch.models.weights import _units
    from watsor_tpu_torch.ops.preprocess import normalize_images

    base = build_detector(config or SSDConfig(), variables=variables,
                          seed=seed, anchors=anchors, device=device)
    cfg = base.config
    model = base.model
    device = base.device
    q_variables = quantize_params(base.variables)
    q_weights = {}                    # parameter name -> QuantizedLeaf
    for path, module in _units(model):
        conv = module.conv if isinstance(module, ConvBNReLU6) else module
        name = '.'.join(path) + ('.conv.weight' if conv is not module
                                 else '.weight')
        node = q_variables['params']
        for key in path:
            node = node[key]
        leaf = node['Conv_0']['kernel'] if conv is not module \
            else node['kernel']
        values = torch.from_numpy(np.ascontiguousarray(
            hwio_to_oihw(leaf.values))).to(device).contiguous(
                memory_format=torch.channels_last)
        # scales along O of the OIHW values
        q_weights[name] = QuantizedLeaf(
            values, torch.from_numpy(leaf.scales).to(device).view(-1, 1, 1,
                                                                  1))
        # the float kernel leaves the device: the int8 values replace it
        conv.weight = torch.nn.Parameter(
            torch.empty(conv.weight.shape, dtype=conv.weight.dtype,
                        device='meta'), requires_grad=False)

    def raw_apply(images_f):
        return functional_call(model, dequantize_params(q_weights, cfg.dtype),
                               (images_f.to(cfg.dtype),))

    anchors_dev = torch.from_numpy(base.anchors).to(device)
    detect_batch = make_detect_batch(
        cfg, anchors_dev, raw_apply,
        lambda x: normalize_images(x, dtype=cfg.dtype))
    return base._replace(variables=q_variables, detect_batch=detect_batch,
                         raw_apply=raw_apply)
