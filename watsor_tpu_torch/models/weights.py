"""The weight bridge between the flax variables tree and the port's modules.

The tree is ``{'params': ..., 'batch_stats': ...}`` with numpy leaves, as
``Detector.params`` of the JAX package holds it or as a ``.npz`` stores it
flat (``path/to/leaf`` keys, watsor_tpu/models/zoo.py:84-86). Each flax
``ConvBNRelu6`` at path P is a ``ConvBNReLU6`` module at the same dotted
path: ``P/Conv_0/kernel`` (HWIO) is ``conv.weight`` (OIHW; a depthwise
``[3, 3, 1, E]`` becomes ``[E, 1, 3, 3]``), ``P/BatchNorm_0/{scale, bias}``
and ``batch_stats`` ``P/BatchNorm_0/{mean, var}`` are the BatchNorm's.
A plain head conv at P has ``P/kernel`` and ``P/bias``.
"""

import math

import numpy as np
import torch
import torch.nn as nn

from watsor_tpu_torch.models.mobilenet_v2 import ConvBNReLU6

# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _units(model):
    """(path tuple, module) for every ConvBNReLU6 and bare head conv."""
    inside_unit = set()
    for name, module in model.named_modules():
        if isinstance(module, ConvBNReLU6):
            inside_unit.add(name + '.conv')
            yield tuple(name.split('.')), module
    for name, module in model.named_modules():
        if isinstance(module, nn.Conv2d) and name not in inside_unit:
            yield tuple(name.split('.')), module


def _get(tree, path):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise KeyError('weights have no entry {}'.format('/'.join(path)))
        node = node[key]
    return np.asarray(node, np.float32)


def _set(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _copy(param, value, path):
    value = torch.from_numpy(np.array(value, np.float32))
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError('{}: weights have shape {}, the model {}'.format(
            '/'.join(path), tuple(value.shape), tuple(param.shape)))
    with torch.no_grad():
        param.copy_(value)


def hwio_to_oihw(kernel):
    return np.transpose(kernel, (3, 2, 0, 1))


def load_variables(model, variables):
    """Copy a flax-layout variables tree into ``model`` (f32 modules)."""
    params = variables['params']
    stats = variables['batch_stats']
    for path, module in _units(model):
        if isinstance(module, ConvBNReLU6):
            _copy(module.conv.weight,
                  hwio_to_oihw(_get(params, path + ('Conv_0', 'kernel'))),
                  path)
            bn = path + ('BatchNorm_0',)
            _copy(module.bn.weight, _get(params, bn + ('scale',)), path)
            _copy(module.bn.bias, _get(params, bn + ('bias',)), path)
            _copy(module.bn.running_mean, _get(stats, bn + ('mean',)), path)
            _copy(module.bn.running_var, _get(stats, bn + ('var',)), path)
        else:
            _copy(module.weight, hwio_to_oihw(_get(params, path + ('kernel',))),
                  path)
            _copy(module.bias, _get(params, path + ('bias',)), path)
    return model


def export_variables(model):
    """The flax-layout variables tree of ``model``, numpy f32 leaves."""
    params, stats = {}, {}

    def np32(t):
        return t.detach().float().cpu().numpy()

    for path, module in _units(model):
        if isinstance(module, ConvBNReLU6):
            _set(params, path + ('Conv_0', 'kernel'),
                 np.transpose(np32(module.conv.weight), (2, 3, 1, 0)))
            bn = path + ('BatchNorm_0',)
            _set(params, bn + ('scale',), np32(module.bn.weight))
            _set(params, bn + ('bias',), np32(module.bn.bias))
            _set(stats, bn + ('mean',), np32(module.bn.running_mean))
            _set(stats, bn + ('var',), np32(module.bn.running_var))
        else:
            _set(params, path + ('kernel',),
                 np.transpose(np32(module.weight), (2, 3, 1, 0)))
            _set(params, path + ('bias',), np32(module.bias))
    return {'params': params, 'batch_stats': stats}


def init_weights(model, generator):
    """Seeded initialization with flax's defaults: lecun-normal conv
    kernels, zero biases, identity BatchNorm."""
    for _, module in _units(model):
        conv = module.conv if isinstance(module, ConvBNReLU6) else module
        fan_in = conv.weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if conv.bias is not None:
                conv.bias.zero_()
        if isinstance(module, ConvBNReLU6):
            module.bn.reset_parameters()
    return model


def unflatten(flat):
    """``{'a/b/c': array}`` -> nested dict (the ``.npz`` layout)."""
    tree = {}
    for key, value in flat.items():
        _set(tree, tuple(key.split('/')), value)
    return tree


def load_npz(path):
    """A flat ``.npz`` of ``path/to/leaf`` arrays -> variables tree."""
    with np.load(path) as data:
        return unflatten({key: data[key] for key in data.files})
