"""The weight bridge between the flax variables tree and the port's modules.

The tree is ``{'params': ..., 'batch_stats': ...}`` with numpy leaves, as
``Detector.params`` of the JAX package holds it or as a ``.npz`` stores it
flat (``path/to/leaf`` keys, watsor_tpu/models/zoo.py:84-86). A module's
flax path is its dotted PyTorch path, each name taken through its parent's
``FLAX_NAMES`` where the parent has one (a ``ConvBNReLU6``'s ``conv`` and
``bn`` are flax's ``Conv_0`` and ``BatchNorm_0``). At flax path P:

- a convolution has ``P/kernel`` (HWIO; OIHW here, so a depthwise
  ``[3, 3, 1, E]`` becomes ``[E, 1, 3, 3]``) and, with a bias, ``P/bias``;
- a BatchNorm has ``P/{scale, bias}`` and ``batch_stats`` ``P/{mean,
  var}``;
- a bare parameter (the BiFPN's fast-attention ``WSM``) is ``P``.

A module used more than once (EfficientDet's head convolutions, shared by
the five levels) is one entry, as in flax.
"""

import math

import numpy as np
import torch
import torch.nn as nn

# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def leaves(model):
    """(flax path tuple, PyTorch dotted name, module or parameter) for every
    convolution, BatchNorm and bare parameter of ``model``."""
    def walk(module, path, name):
        for pname, param in module.named_parameters(recurse=False):
            yield path + (pname,), name + pname, param
        names = getattr(module, 'FLAX_NAMES', {})
        for child_name, child in module.named_children():
            child_path = path + (names.get(child_name, child_name),)
            child_torch = name + child_name
            if isinstance(child, (nn.Conv2d, nn.BatchNorm2d)):
                yield child_path, child_torch, child
            else:
                yield from walk(child, child_path, child_torch + '.')
    yield from walk(model, (), '')


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
    stats = variables.get('batch_stats', {})
    for path, _, leaf in leaves(model):
        if isinstance(leaf, nn.Conv2d):
            _copy(leaf.weight,
                  hwio_to_oihw(_get(params, path + ('kernel',))), path)
            if leaf.bias is not None:
                _copy(leaf.bias, _get(params, path + ('bias',)), path)
        elif isinstance(leaf, nn.BatchNorm2d):
            _copy(leaf.weight, _get(params, path + ('scale',)), path)
            _copy(leaf.bias, _get(params, path + ('bias',)), path)
            _copy(leaf.running_mean, _get(stats, path + ('mean',)), path)
            _copy(leaf.running_var, _get(stats, path + ('var',)), path)
        else:
            _copy(leaf, _get(params, path), path)
    return model


def export_variables(model, dtype=np.float32):
    """The flax-layout variables tree of ``model``: numpy leaves of
    ``dtype`` (f32; f64 reads a model kept in f64 exactly), each a copy."""
    params, stats = {}, {}
    to = {np.float32: torch.float32, np.float64: torch.float64}[
        np.dtype(dtype).type]

    def to_numpy(t):
        return t.detach().to('cpu', to).numpy().copy()

    for path, _, leaf in leaves(model):
        if isinstance(leaf, nn.Conv2d):
            _set(params, path + ('kernel',),
                 np.transpose(to_numpy(leaf.weight), (2, 3, 1, 0)))
            if leaf.bias is not None:
                _set(params, path + ('bias',), to_numpy(leaf.bias))
        elif isinstance(leaf, nn.BatchNorm2d):
            _set(params, path + ('scale',), to_numpy(leaf.weight))
            _set(params, path + ('bias',), to_numpy(leaf.bias))
            _set(stats, path + ('mean',), to_numpy(leaf.running_mean))
            _set(stats, path + ('var',), to_numpy(leaf.running_var))
        else:
            _set(params, path, to_numpy(leaf))
    return {'params': params, 'batch_stats': stats}


def init_weights(model, generator):
    """Seeded initialization with flax's defaults: lecun-normal conv
    kernels, zero biases, identity BatchNorm, bare parameters one (the
    fast-attention weights' init)."""
    for _, _, leaf in leaves(model):
        with torch.no_grad():
            if isinstance(leaf, nn.Conv2d):
                fan_in = leaf.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(leaf.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                if leaf.bias is not None:
                    leaf.bias.zero_()
            elif isinstance(leaf, nn.BatchNorm2d):
                leaf.reset_parameters()
            else:
                leaf.fill_(1.0)
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
