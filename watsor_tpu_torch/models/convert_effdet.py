# Copy of watsor_tpu/models/convert_effdet.py: imports and paths adapted.
"""Weight conversion: public automl EfficientDet-Lite checkpoints -> the
flax-layout variables tree of the port's EfficientDet, with numerically
matching activations.

The reference can only serve EfficientDet-Lite as an opaque TFLite
flatbuffer; here the published ``efficientdet-lite{0..4}`` training
checkpoints (the google/automl release tarballs, ``model.ckpt*``/``ckpt*``
TF checkpoint format) convert into the architecture of
models/efficientdet.py.

Checkpoint variable layout (the automl naming)::

    efficientnet-lite0/stem/conv2d/kernel                       -> stem
    efficientnet-lite0/stem/tpu_batch_normalization/{gamma,beta,
        moving_mean,moving_variance}
    efficientnet-lite0/blocks_{i}/conv2d[_1]/kernel             -> block{i}
    efficientnet-lite0/blocks_{i}/depthwise_conv2d/depthwise_kernel
    efficientnet-lite0/blocks_{i}/tpu_batch_normalization[_{1,2}]/...
    resample_p6/conv2d/kernel + resample_p6/bn/...              -> resample_p6
    fpn_cells/cell_{r}/fnode{k}/op_after_combine{5+k}/conv/
        {depthwise_kernel,pointwise_kernel,bias}                -> bifpn{r}/fnode{k}/conv
    fpn_cells/cell_{r}/fnode{k}/op_after_combine{5+k}/bn/...    -> bifpn{r}/fnode{k}/bn
    fpn_cells/cell_0/fnode{k}/resample_*_*_*/conv2d/kernel (+/bn)
                                                                -> bifpn0/fnode{k}/resample
    fpn_cells/cell_{r}/fnode{k}/WSM[_j]  (fastattn models only) -> bifpn{r}/fnode{k}/WSM
    class_net/class-{r}/{depthwise_kernel,pointwise_kernel,bias}-> cls_head/sep{r}
    class_net/class-{r}-bn-{level}/...                          -> cls_head/bn{r}_l{level-3}
    class_net/class-predict/...                                 -> cls_head/predict
    box_net/box-{r}/..., box-{r}-bn-{level}, box-predict        -> box_head/...

Geometry (variant, fpn channels/repeats, head repeats, class count, fusion
method) is inferred from the checkpoint itself; the class head carries NO
background column (the automl sigmoid convention,
``explicit_background=False``).

TensorFlow is needed for checkpoint reading only (convert.py's reader).
"""

import re

import numpy as np

from watsor_tpu_torch.models.convert import MissingVariable


def _get(variables, name):
    try:
        return np.asarray(variables[name])
    except KeyError:
        raise MissingVariable(name)


def _bn_unit(variables, scope):
    """automl BN scope -> (params leaf, batch_stats leaf)."""
    return ({'scale': _get(variables, scope + '/gamma'),
             'bias': _get(variables, scope + '/beta')},
            {'mean': _get(variables, scope + '/moving_mean'),
             'var': _get(variables, scope + '/moving_variance')})


def _conv_bn_unit(variables, conv_name, bn_scope, depthwise=False):
    """One conv2d+BN pair -> the ConvBN subtree (Conv_0/BatchNorm_0)."""
    kernel = _get(variables, conv_name)
    if depthwise:
        # TF depthwise kernel [kh, kw, C, 1] -> flax grouped-conv
        # kernel [kh, kw, 1, C]
        kernel = np.transpose(kernel, (0, 1, 3, 2))
    bn_p, bn_s = _bn_unit(variables, bn_scope)
    return ({'Conv_0': {'kernel': kernel}, 'BatchNorm_0': bn_p},
            {'BatchNorm_0': bn_s})


def _sep_conv(variables, scope):
    """automl SeparableConv2D scope -> the flax SeparableConv subtree."""
    dw = np.transpose(_get(variables, scope + '/depthwise_kernel'),
                      (0, 1, 3, 2))
    return {'dw': {'kernel': dw},
            'pw': {'kernel': _get(variables, scope + '/pointwise_kernel'),
                   'bias': _get(variables, scope + '/bias')}}


def _backbone(variables, variant, params, stats):
    from watsor_tpu_torch.models.efficientnet_lite import lite_block_args
    root = 'efficientnet-{}/'.format(variant)
    p, s = {}, {}

    p['stem'], s['stem'] = _conv_bn_unit(
        variables, root + 'stem/conv2d/kernel',
        root + 'stem/tpu_batch_normalization')
    for i, (expand, _, _, _, _) in enumerate(lite_block_args(variant)):
        scope = root + 'blocks_{}'.format(i)
        block_p, block_s = {}, {}
        if expand != 1:
            block_p['expand'], block_s['expand'] = _conv_bn_unit(
                variables, scope + '/conv2d/kernel',
                scope + '/tpu_batch_normalization')
            dw_bn, proj_conv, proj_bn = ('_1', '/conv2d_1/kernel', '_2')
        else:
            dw_bn, proj_conv, proj_bn = ('', '/conv2d/kernel', '_1')
        block_p['depthwise'], block_s['depthwise'] = _conv_bn_unit(
            variables, scope + '/depthwise_conv2d/depthwise_kernel',
            scope + '/tpu_batch_normalization' + dw_bn, depthwise=True)
        block_p['project'], block_s['project'] = _conv_bn_unit(
            variables, scope + proj_conv,
            scope + '/tpu_batch_normalization' + proj_bn)
        p['block{}'.format(i)] = block_p
        s['block{}'.format(i)] = block_s
    params['backbone'] = p
    stats['backbone'] = s


# first-cell fusion nodes whose first input is a raw backbone tap needing a
# channel projection: fnode1..3 (P5/P4/P3 top-down) and fnode4/5 (P4/P5
# bottom-up, projected AGAIN with independent weights)
_RESAMPLED_FNODES = (1, 2, 3, 4, 5)


def _find_resample_scope(variables, cell, fnode):
    prefix = 'fpn_cells/cell_{}/fnode{}/resample_'.format(cell, fnode)
    for name in variables:
        if name.startswith(prefix) and name.endswith('/conv2d/kernel'):
            return name[:-len('/conv2d/kernel')]
    raise MissingVariable(prefix + '*/conv2d/kernel')


def _fpn(variables, cfg, params, stats):
    params['resample_p6'], stats['resample_p6'] = _conv_bn_unit(
        variables, 'resample_p6/conv2d/kernel', 'resample_p6/bn')
    for r in range(cfg.fpn_repeats):
        cell_p, cell_s = {}, {}
        for k in range(8):
            scope = 'fpn_cells/cell_{}/fnode{}'.format(r, k)
            node_p, node_s = {}, {}
            op = scope + '/op_after_combine{}'.format(5 + k)
            node_p['conv'] = _sep_conv(variables, op + '/conv')
            node_p['bn'], node_s['bn'] = _bn_unit(variables, op + '/bn')
            if r == 0 and k in _RESAMPLED_FNODES:
                rs_scope = _find_resample_scope(variables, r, k)
                node_p['resample'], node_s['resample'] = _conv_bn_unit(
                    variables, rs_scope + '/conv2d/kernel', rs_scope + '/bn')
            if cfg.fpn_weight_method == 'fastattn':
                wsm = [_get(variables, scope + '/WSM')]
                j = 1
                while scope + '/WSM_{}'.format(j) in variables:
                    wsm.append(_get(variables,
                                    scope + '/WSM_{}'.format(j)))
                    j += 1
                node_p['WSM'] = np.stack([w.reshape(()) for w in wsm])
            cell_p['fnode{}'.format(k)] = node_p
            cell_s['fnode{}'.format(k)] = node_s
        params['bifpn{}'.format(r)] = cell_p
        stats['bifpn{}'.format(r)] = cell_s


def _head(variables, cfg, net, prefix, params, stats):
    """net: 'class_net'/'box_net' with automl layer prefix 'class'/'box'."""
    head_p, head_s = {}, {}
    for r in range(cfg.head_repeats):
        head_p['sep{}'.format(r)] = _sep_conv(
            variables, '{}/{}-{}'.format(net, prefix, r))
        for level in range(cfg.num_levels):
            bn_scope = '{}/{}-{}-bn-{}'.format(net, prefix, r,
                                               cfg.min_level + level)
            key = 'bn{}_l{}'.format(r, level)
            head_p[key], head_s[key] = _bn_unit(variables, bn_scope)
    head_p['predict'] = _sep_conv(variables,
                                  '{}/{}-predict'.format(net, prefix))
    flax_name = 'cls_head' if prefix == 'class' else 'box_head'
    params[flax_name] = head_p
    stats[flax_name] = head_s


def is_effdet_checkpoint(variables):
    return any(name.startswith('fpn_cells/') for name in variables)


def infer_effdet_config(variables):
    """Variant, FPN/head geometry, class count and fusion method from the
    checkpoint's own names and shapes."""
    from watsor_tpu_torch.models.efficientdet import lite_config
    variant = None
    for name in variables:
        m = re.match(r'^efficientnet-(lite\d)/', name)
        if m:
            variant = m.group(1)
            break
    if variant is None:
        raise MissingVariable('efficientnet-lite*/stem/conv2d/kernel '
                              '(only the Lite variants are supported)')
    cfg = lite_config(variant)

    cells = set()
    head_reps = set()
    fastattn = False
    for name in variables:
        m = re.match(r'^fpn_cells/cell_(\d+)/', name)
        if m:
            cells.add(int(m.group(1)))
        m = re.match(r'^class_net/class-(\d+)/', name)
        if m:
            head_reps.add(int(m.group(1)))
        if re.search(r'/WSM(_\d+)?$', name):
            fastattn = True
    if not cells or not head_reps:
        raise MissingVariable('fpn_cells/... and class_net/... variables')

    fpn_channels = int(_get(variables,
                            'resample_p6/conv2d/kernel').shape[-1])
    anchors = int(_get(variables,
                       'box_net/box-predict/pointwise_kernel').shape[-1]) // 4
    if anchors != cfg.anchors_per_cell:
        raise ValueError(
            'checkpoint predicts {} anchors per cell; only the standard '
            'EfficientDet 3-scale x 3-aspect grid ({}) is supported'.format(
                anchors, cfg.anchors_per_cell))
    num_classes = int(_get(variables,
                           'class_net/class-predict/bias').size) // anchors
    return cfg._replace(
        fpn_channels=fpn_channels,
        fpn_repeats=max(cells) + 1,
        head_repeats=max(head_reps) + 1,
        num_classes=num_classes,
        explicit_background=False,
        fpn_weight_method='fastattn' if fastattn else 'sum')


def automl_effdet_variables_to_flax(variables, config):
    """automl variable dict {name: array} -> flax variables tree of the
    EfficientDet of ``config`` (models/efficientdet.py)."""
    params, stats = {}, {}
    _backbone(variables, config.variant, params, stats)
    _fpn(variables, config, params, stats)
    _head(variables, config, 'class_net', 'class', params, stats)
    _head(variables, config, 'box_net', 'box', params, stats)
    return {'params': params, 'batch_stats': stats}


def convert_automl_effdet_checkpoint(checkpoint_path, config=None):
    """checkpoint -> (flax variables, EfficientDetConfig). Geometry is
    inferred from the checkpoint unless ``config`` is given."""
    from watsor_tpu_torch.models.convert import load_tf_checkpoint_variables
    variables = load_tf_checkpoint_variables(checkpoint_path)
    if config is None:
        config = infer_effdet_config(variables)
    return automl_effdet_variables_to_flax(variables, config), config
