"""A flax-layout variables tree named as the public TF checkpoints name
it: the inverse of models/convert.py's mappers (the TF-OD-API slim names of
``ssd_mobilenet_v2_coco_2018_03_29`` and its v1, SSDLite and Inception
siblings) and of models/convert_effdet.py's (the automl names of
``efficientdet-lite{0..4}``).

Test support, not a feature: it turns a seeded tree into the {name:
array} dict a checkpoint reader returns, so the converters can be driven
with no TensorFlow and no download (chip_smoke.py's phase 8 on the card),
or written into a real checkpoint where TensorFlow is installed (the CPU
tests). Kernels are written in TF's layouts: HWIO, depthwise [kh, kw, C,
1], Inception's stem depthwise [7, 7, 3, 8].
"""

import numpy as np

from watsor_tpu_torch.models.efficientnet_lite import lite_block_args
from watsor_tpu_torch.models.inception_v2 import INCEPTION_V2_BLOCKS

_V2_ROOT = 'FeatureExtractor/MobilenetV2/'
_V1_ROOT = 'FeatureExtractor/MobilenetV1/'
_INCEPTION_ROOT = 'FeatureExtractor/InceptionV2/'
_HEADS = (('box_head', 'BoxEncodingPredictor'), ('cls_head', 'ClassPredictor'))


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _depthwise(kernel):
    """flax grouped-conv [kh, kw, 1, C] -> TF depthwise [kh, kw, C, 1]."""
    return np.transpose(np.asarray(kernel), (0, 1, 3, 2))


def _v2_units(cfg):
    """(flax path, slim scope, depthwise) of each conv+BN unit of an
    SSD-MobileNetV2 (plain or SSDLite), as tf_od_variables_to_flax reads
    them."""
    units = [(('backbone', 'stem'), _V2_ROOT + 'Conv', False),
             (('backbone', 'block0', 'depthwise'),
              _V2_ROOT + 'expanded_conv/depthwise', True),
             (('backbone', 'block0', 'project'),
              _V2_ROOT + 'expanded_conv/project', False)]
    for n in range(1, 17):
        scope = _V2_ROOT + 'expanded_conv_{}/'.format(n)
        for stage in ('expand', 'depthwise', 'project'):
            path = ('backbone', 'block13_' + stage) if n == 13 else \
                ('backbone', 'block{}'.format(n), stage)
            units.append((path, scope + stage, stage == 'depthwise'))
    units.append((('backbone', 'head'), _V2_ROOT + 'Conv_1', False))
    for i, ch in enumerate(cfg.extra_features):
        units.append((('extra{}_pw'.format(i),), _V2_ROOT +
                      'layer_19_1_Conv2d_{}_1x1_{}'.format(i + 2, ch // 2),
                      False))
        scope = _V2_ROOT + 'layer_19_2_Conv2d_{}_3x3_s2_{}'.format(i + 2, ch)
        if cfg.lite:
            units.append((('extra{}_dw'.format(i),), scope + '_depthwise',
                          True))
        units.append((('extra{}'.format(i),), scope, False))
    if cfg.lite:
        for i in range(cfg.anchor_spec.num_layers):
            for head, slim in _HEADS:
                units.append((('{}{}_dw'.format(head, i),),
                              'BoxPredictor_{}/{}_depthwise'.format(i, slim),
                              True))
    return units


def _v1_units(cfg):
    units = [(('backbone', 'stem'), _V1_ROOT + 'Conv2d_0', False)]
    for n in range(1, 14):
        for kind in ('depthwise', 'pointwise'):
            units.append((('backbone', 'unit{}_{}'.format(n, kind)),
                          _V1_ROOT + 'Conv2d_{}_{}'.format(n, kind),
                          kind == 'depthwise'))
    for i, ch in enumerate(cfg.extra_features):
        units.append((('extra{}_pw'.format(i),), _V1_ROOT +
                      'Conv2d_13_pointwise_1_Conv2d_{}_1x1_{}'.format(
                          i + 2, ch // 2), False))
        units.append((('extra{}'.format(i),), _V1_ROOT +
                      'Conv2d_13_pointwise_2_Conv2d_{}_3x3_s2_{}'.format(
                          i + 2, ch), False))
    return units


def _inception_units(cfg):
    """Every conv+BN unit but the separable stem."""
    units = [(('backbone', 'conv2b'), _INCEPTION_ROOT + 'Conv2d_2b_1x1',
              False),
             (('backbone', 'conv2c'), _INCEPTION_ROOT + 'Conv2d_2c_3x3',
              False)]
    for name, b0, *_ in INCEPTION_V2_BLOCKS:
        scope = _INCEPTION_ROOT + 'Mixed_' + name.split('_')[1] + '/'
        if b0 is None:
            branches = (('b0_0', 'Branch_0/Conv2d_0a_1x1'),
                        ('b0_1', 'Branch_0/Conv2d_1a_3x3'),
                        ('b1_0', 'Branch_1/Conv2d_0a_1x1'),
                        ('b1_1', 'Branch_1/Conv2d_0b_3x3'),
                        ('b1_2', 'Branch_1/Conv2d_1a_3x3'))
        else:
            branches = (('b0', 'Branch_0/Conv2d_0a_1x1'),
                        ('b1_0', 'Branch_1/Conv2d_0a_1x1'),
                        ('b1_1', 'Branch_1/Conv2d_0b_3x3'),
                        ('b2_0', 'Branch_2/Conv2d_0a_1x1'),
                        ('b2_1', 'Branch_2/Conv2d_0b_3x3'),
                        ('b2_2', 'Branch_2/Conv2d_0c_3x3'),
                        ('b3', 'Branch_3/Conv2d_0b_1x1'))
        units += [(('backbone', name, key), scope + slim, False)
                  for key, slim in branches]
    for i, ch in enumerate(cfg.extra_features):
        units.append((('extra{}_pw'.format(i),), _INCEPTION_ROOT +
                      'Mixed_5c_1_Conv2d_{}_1x1_{}'.format(i + 2, ch // 2),
                      False))
        units.append((('extra{}'.format(i),), _INCEPTION_ROOT +
                      'Mixed_5c_2_Conv2d_{}_3x3_s2_{}'.format(i + 2, ch),
                      False))
    return units


def _put_bn(out, scope, params, stats):
    out[scope + '/BatchNorm/gamma'] = np.asarray(params['scale'])
    out[scope + '/BatchNorm/beta'] = np.asarray(params['bias'])
    out[scope + '/BatchNorm/moving_mean'] = np.asarray(stats['mean'])
    out[scope + '/BatchNorm/moving_variance'] = np.asarray(stats['var'])


def tf_od_variables(variables, config):
    """An SSD's flax variables tree (``config``: its SSDConfig, any of the
    three backbones, plain or SSDLite) -> {slim name: array}, the dict
    ``load_tf_checkpoint_variables`` returns for the public checkpoint of
    that family; ``convert_tf_od_variables`` maps it back."""
    params, stats = variables['params'], variables['batch_stats']
    out = {}
    units = {'mobilenet_v2': _v2_units, 'mobilenet_v1': _v1_units,
             'inception_v2': _inception_units}[config.backbone](config)
    for path, scope, depthwise in units:
        p, s = _at(params, path), _at(stats, path)
        kernel = p['Conv_0']['kernel']
        out[scope + ('/depthwise_weights' if depthwise else '/weights')] = \
            _depthwise(kernel) if depthwise else np.asarray(kernel)
        _put_bn(out, scope, p['BatchNorm_0'], s['BatchNorm_0'])
    if config.backbone == 'inception_v2':
        # one separable unit: depthwise [7, 7, 3, 8] (output channel 8i + j
        # is input i, filter j) and pointwise kernels, one BatchNorm
        scope = _INCEPTION_ROOT + 'Conv2d_1a_7x7'
        stem = params['backbone']['stem']
        dw = np.asarray(stem['dw']['kernel'])
        kh, kw, _, channels = dw.shape
        out[scope + '/depthwise_weights'] = dw.reshape(kh, kw, 3,
                                                       channels // 3)
        out[scope + '/pointwise_weights'] = np.asarray(stem['pw']['kernel'])
        _put_bn(out, scope, stem['BatchNorm_0'],
                stats['backbone']['stem']['BatchNorm_0'])
    for i in range(config.anchor_spec.num_layers):
        for head, slim in _HEADS:
            p = params['{}{}'.format(head, i)]
            scope = 'BoxPredictor_{}/{}'.format(i, slim)
            out[scope + '/weights'] = np.asarray(p['kernel'])
            out[scope + '/biases'] = np.asarray(p['bias'])
    return out


def _automl_bn(out, scope, params, stats):
    out[scope + '/gamma'] = np.asarray(params['scale'])
    out[scope + '/beta'] = np.asarray(params['bias'])
    out[scope + '/moving_mean'] = np.asarray(stats['mean'])
    out[scope + '/moving_variance'] = np.asarray(stats['var'])


def _automl_conv_bn(out, conv_name, bn_scope, params, stats,
                    depthwise=False):
    kernel = params['Conv_0']['kernel']
    out[conv_name] = _depthwise(kernel) if depthwise else np.asarray(kernel)
    _automl_bn(out, bn_scope, params['BatchNorm_0'], stats['BatchNorm_0'])


def _automl_sep(out, scope, params):
    out[scope + '/depthwise_kernel'] = _depthwise(params['dw']['kernel'])
    out[scope + '/pointwise_kernel'] = np.asarray(params['pw']['kernel'])
    out[scope + '/bias'] = np.asarray(params['pw']['bias'])


def automl_effdet_variables(variables, config):
    """An EfficientDet-Lite's flax variables tree (``config``: its
    EfficientDetConfig) -> {automl name: array}, the dict of the published
    ``efficientdet-lite*`` checkpoint; ``automl_effdet_variables_to_flax``
    maps it back."""
    params, stats = variables['params'], variables['batch_stats']
    out = {}
    root = 'efficientnet-{}/'.format(config.variant)
    bp, bs = params['backbone'], stats['backbone']
    _automl_conv_bn(out, root + 'stem/conv2d/kernel',
                    root + 'stem/tpu_batch_normalization', bp['stem'],
                    bs['stem'])
    for i, (expand, *_) in enumerate(lite_block_args(config.variant)):
        scope = root + 'blocks_{}'.format(i)
        p, s = bp['block{}'.format(i)], bs['block{}'.format(i)]
        bn = scope + '/tpu_batch_normalization'
        if expand != 1:
            _automl_conv_bn(out, scope + '/conv2d/kernel', bn, p['expand'],
                            s['expand'])
            dw_bn, proj_conv, proj_bn = '_1', '/conv2d_1/kernel', '_2'
        else:
            dw_bn, proj_conv, proj_bn = '', '/conv2d/kernel', '_1'
        _automl_conv_bn(out, scope + '/depthwise_conv2d/depthwise_kernel',
                        bn + dw_bn, p['depthwise'], s['depthwise'],
                        depthwise=True)
        _automl_conv_bn(out, scope + proj_conv, bn + proj_bn, p['project'],
                        s['project'])
    _automl_conv_bn(out, 'resample_p6/conv2d/kernel', 'resample_p6/bn',
                    params['resample_p6'], stats['resample_p6'])
    for r in range(config.fpn_repeats):
        for k in range(8):
            p = params['bifpn{}'.format(r)]['fnode{}'.format(k)]
            s = stats['bifpn{}'.format(r)]['fnode{}'.format(k)]
            scope = 'fpn_cells/cell_{}/fnode{}'.format(r, k)
            op = scope + '/op_after_combine{}'.format(5 + k)
            _automl_sep(out, op + '/conv', p['conv'])
            _automl_bn(out, op + '/bn', p['bn'], s['bn'])
            if 'resample' in p:
                rs = scope + '/resample_0_{}_{}'.format(k, 5 + k)
                _automl_conv_bn(out, rs + '/conv2d/kernel', rs + '/bn',
                                p['resample'], s['resample'])
            if 'WSM' in p:
                for j, w in enumerate(np.asarray(p['WSM'])):
                    out[scope + ('/WSM_{}'.format(j) if j else '/WSM')] = \
                        np.asarray(w)
    for net, prefix, head in (('class_net', 'class', 'cls_head'),
                              ('box_net', 'box', 'box_head')):
        p, s = params[head], stats[head]
        for r in range(config.head_repeats):
            _automl_sep(out, '{}/{}-{}'.format(net, prefix, r),
                        p['sep{}'.format(r)])
            for level in range(config.num_levels):
                key = 'bn{}_l{}'.format(r, level)
                _automl_bn(out, '{}/{}-{}-bn-{}'.format(
                    net, prefix, r, config.min_level + level), p[key], s[key])
        _automl_sep(out, '{}/{}-predict'.format(net, prefix), p['predict'])
    return out
