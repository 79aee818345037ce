"""SSD-MobileNetV2 forward with fused inverted-residual blocks
(counterpart of watsor_tpu/models/ssd_fused.py).

BatchNorm is folded into each convolution, so the walk consumes a pack of
(kernel, bias) tensors built once from the variables tree. The 12 stride-1
blocks with an expand stage run ops/fused_block.fused_inverted_residual
(the CUDA kernel on the card); every other convolution runs as a plain
PyTorch convolution. Enabled in the application with WATSOR_FUSED_BLOCKS=1.
"""

import functools

import numpy as np
import torch

from watsor_tpu_torch.models.mobilenet_v2 import (BN_EPS, TAP_BLOCK,
                                                  block_plan, conv_same,
                                                  relu6)
from watsor_tpu_torch.models.ssd import (SSDConfig, apply_heads,
                                         make_detect_batch)
from watsor_tpu_torch.models.weights import hwio_to_oihw
from watsor_tpu_torch.ops.fused_block import fused_inverted_residual
from watsor_tpu_torch.ops.preprocess import normalize_images


# copied from watsor_tpu/models/ssd_int8.py:54-62 (that module imports jax)
def fold_unit(unit_params, unit_stats):
    """ConvBNRelu6 params + batch stats -> (folded kernel, bias)."""
    kernel = np.asarray(unit_params['Conv_0']['kernel'], np.float32)
    gamma = np.asarray(unit_params['BatchNorm_0']['scale'], np.float32)
    beta = np.asarray(unit_params['BatchNorm_0']['bias'], np.float32)
    mean = np.asarray(unit_stats['BatchNorm_0']['mean'], np.float32)
    var = np.asarray(unit_stats['BatchNorm_0']['var'], np.float32)
    factor = gamma / np.sqrt(var + BN_EPS)
    return kernel * factor, beta - mean * factor


def _fuses(index, expand, strides):
    """Blocks the fused kernel runs: stride 1 with an expand stage."""
    return index != TAP_BLOCK and strides == 1 and expand != 1


def build_folded_pack(variables, cfg: SSDConfig, device):
    """Folded weights on ``device``: convolutions as (OIHW kernel, bias) in
    the activation dtype; fused blocks as the kernel's operands, weights
    bf16 and biases f32 (cast here, once, not on every call)."""
    params = variables['params']
    stats = variables['batch_stats']
    dtype = cfg.dtype

    def folded(*path):
        node_p, node_s = params, stats
        for key in path:
            node_p, node_s = node_p[key], node_s[key]
        return fold_unit(node_p, node_s)

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, np.float32, order='C')).to(
            device, dtype)

    def conv_unit(kernel, bias):
        return (tensor(hwio_to_oihw(kernel), dtype)
                .contiguous(memory_format=torch.channels_last),
                tensor(bias, dtype))

    def conv(*path):
        return conv_unit(*folded(*path))

    pack = {'backbone/stem': conv('backbone', 'stem'),
            'backbone/head': conv('backbone', 'head')}
    for index, expand, _, strides in block_plan():
        block = 'block{}'.format(index)
        if index == TAP_BLOCK:
            for part in ('expand', 'depthwise', 'project'):
                key = 'block13_' + part
                pack['backbone/' + key] = conv('backbone', key)
        elif _fuses(index, expand, strides):
            # 1x1 kernels flatten to [C_in, E] / [E, C_out], the depthwise
            # kernel [3, 3, 1, E] to [3, 3, E]
            we, be = folded('backbone', block, 'expand')
            wd, bd = folded('backbone', block, 'depthwise')
            wp, bp = folded('backbone', block, 'project')
            pack['backbone/' + block] = dict(
                we=tensor(we.reshape(we.shape[2:]), torch.bfloat16),
                be=tensor(be, torch.float32),
                wdw=tensor(wd.reshape(3, 3, -1), torch.bfloat16),
                bdw=tensor(bd, torch.float32),
                wp=tensor(wp.reshape(wp.shape[2:]), torch.bfloat16),
                bp=tensor(bp, torch.float32))
        else:
            for part in ('expand', 'depthwise', 'project'):
                if part == 'expand' and expand == 1:
                    continue
                pack['backbone/{}/{}'.format(block, part)] = \
                    conv('backbone', block, part)
    for i in range(len(cfg.extra_features)):
        pack['extra{}_pw'.format(i)] = conv('extra{}_pw'.format(i))
        pack['extra{}'.format(i)] = conv('extra{}'.format(i))
    for key, value in params.items():
        if key.startswith(('box_head', 'cls_head')):
            pack[key] = conv_unit(value['kernel'], value['bias'])
    return pack


def _conv(x, unit, strides=1, groups=1, use_relu=True):
    y = conv_same(x, unit[0], unit[1], stride=strides, groups=groups)
    return relu6(y) if use_relu else y


def fused_features(pack, x, cfg: SSDConfig):
    """NCHW (channels_last) input -> the six SSD feature maps."""
    x = _conv(x, pack['backbone/stem'], strides=2)
    tap_c4 = None
    prev_features = x.shape[1]
    for index, expand, features, strides in block_plan():
        block = 'backbone/block{}'.format(index)
        if index == TAP_BLOCK:
            tap_c4 = _conv(x, pack['backbone/block13_expand'])
            y = _conv(tap_c4, pack['backbone/block13_depthwise'],
                      strides=strides, groups=tap_c4.shape[1])
            x = _conv(y, pack['backbone/block13_project'], use_relu=False)
        elif _fuses(index, expand, strides):
            w = pack[block]
            nhwc = x.permute(0, 2, 3, 1).contiguous()
            y = fused_inverted_residual(
                nhwc, w['we'], w['be'], w['wdw'], w['bdw'], w['wp'],
                w['bp'], residual=prev_features == features)
            x = y.permute(0, 3, 1, 2)
        else:
            y = x
            if expand != 1:
                y = _conv(y, pack[block + '/expand'])
            y = _conv(y, pack[block + '/depthwise'], strides=strides,
                      groups=y.shape[1])
            y = _conv(y, pack[block + '/project'], use_relu=False)
            x = y + x if strides == 1 and prev_features == features else y
        prev_features = features
    c5 = _conv(x, pack['backbone/head'])
    feats = [tap_c4, c5]
    y = c5
    for i in range(len(cfg.extra_features)):
        y = _conv(y, pack['extra{}_pw'.format(i)])
        y = _conv(y, pack['extra{}'.format(i)], strides=2)
        feats.append(y)
    return feats


def build_fused_detector(detector):
    """The same Detector contract with the fused walk as its forward."""
    cfg = detector.config
    pack = build_folded_pack(detector.variables, cfg, detector.device)
    num_heads = len(cfg.extra_features) + 2
    heads = [(pack['box_head{}'.format(i)], pack['cls_head{}'.format(i)])
             for i in range(num_heads)]
    anchors_dev = torch.from_numpy(detector.anchors).to(detector.device)

    def raw_apply(images_f):
        x = images_f.to(cfg.dtype).permute(0, 3, 1, 2)
        return apply_heads(fused_features(pack, x, cfg), heads,
                           cfg.num_classes + 1)

    detect_batch = make_detect_batch(
        cfg, anchors_dev, raw_apply,
        functools.partial(normalize_images, dtype=cfg.dtype))
    return detector._replace(model=None, detect_batch=detect_batch,
                             raw_apply=raw_apply)
