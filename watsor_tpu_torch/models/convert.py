# Copy of watsor_tpu/models/convert.py: imports and paths adapted.
"""Weight conversion: public TF/Keras SSD checkpoints -> the flax-layout
variables tree of the port's detectors, with numerically matching
activations.

The reference consumes SSD-MobileNet graphs as opaque binaries; here the
public checkpoints load into the port's PyTorch modules through the same
flax-layout tree the JAX package writes (``models/weights.py`` bridges it
into the modules), so ``save_weights`` gives the JAX converter's
``.msgpack`` bytes.

Two sources are supported:

1. **TF Object Detection API checkpoints** (the full detector: backbone,
   extras and box/class heads). The canonical public model is
   ``ssd_mobilenet_v2_coco_2018_03_29`` from the TF1 detection model zoo,
   whose ``model.ckpt`` carries slim-style variable names::

       FeatureExtractor/MobilenetV2/Conv/weights (+/BatchNorm/{gamma,beta,
           moving_mean,moving_variance})                    -> stem
       FeatureExtractor/MobilenetV2/expanded_conv/...       -> block0
       FeatureExtractor/MobilenetV2/expanded_conv_N/
           {expand,depthwise,project}/...                   -> blockN
       FeatureExtractor/MobilenetV2/Conv_1/...              -> head
       FeatureExtractor/MobilenetV2/layer_19_1_Conv2d_{i}_1x1_{c}
                                                            -> extra{i-2}_pw
       FeatureExtractor/MobilenetV2/layer_19_2_Conv2d_{i}_3x3_s2_{c}
                                                            -> extra{i-2}
       BoxPredictor_{i}/BoxEncodingPredictor/{weights,biases} -> box_head{i}
       BoxPredictor_{i}/ClassPredictor/{weights,biases}       -> cls_head{i}

   End-to-end CLI::

       python -m watsor_tpu_torch.models.convert \
           --checkpoint .../model.ckpt --output /usr/share/watsor/model

2. **Keras MobileNetV2 models** (backbone only, e.g. ImageNet weights for
   training a fresh head).

Reading a checkpoint, a frozen graph or a Keras model needs TensorFlow,
imported only inside those readers; the mappers are numpy over a
{name: array} dict, and everything else in the port works without it.
"""

import numpy as np


def _bn(weights):
    gamma, beta, mean, var = weights
    return ({'scale': np.asarray(gamma), 'bias': np.asarray(beta)},
            {'mean': np.asarray(mean), 'var': np.asarray(var)})


def _conv_bn(conv_weights, bn_weights, depthwise=False):
    kernel = np.asarray(conv_weights[0])
    if depthwise:
        # keras depthwise kernel [kh, kw, in, 1] -> flax grouped-conv
        # kernel [kh, kw, 1, in]
        kernel = np.transpose(kernel, (0, 1, 3, 2))
    bn_params, bn_stats = _bn(bn_weights)
    return ({'Conv_0': {'kernel': kernel}, 'BatchNorm_0': bn_params},
            {'BatchNorm_0': bn_stats})


def keras_mobilenet_v2_to_flax(keras_model):
    """Keras MobileNetV2 (any alpha) -> (params, batch_stats) trees shaped
    for the flax MobileNetV2Backbone (models/mobilenet_v2.py's layout)."""
    layers = {layer.name: layer for layer in keras_model.layers}

    def weights_of(name):
        return [np.asarray(w) for w in layers[name].get_weights()]

    params = {}
    stats = {}

    def put(module, sub, conv_name, bn_name, depthwise=False):
        p, s = _conv_bn(weights_of(conv_name), weights_of(bn_name),
                        depthwise)
        params.setdefault(module, {})
        stats.setdefault(module, {})
        if sub is None:
            params[module] = p
            stats[module] = s
        else:
            params[module][sub] = p
            stats[module][sub] = s

    put('stem', None, 'Conv1', 'bn_Conv1')
    # block 0: expand ratio 1 (no expand conv)
    put('block0', 'depthwise', 'expanded_conv_depthwise',
        'expanded_conv_depthwise_BN', depthwise=True)
    put('block0', 'project', 'expanded_conv_project',
        'expanded_conv_project_BN')
    for n in range(1, 17):
        prefix = 'block_{}_'.format(n)
        module = 'block{}'.format(n)
        if n == 13:
            # our backbone names block13's stages explicitly (the C4 tap)
            put('block13_expand', None, prefix + 'expand',
                prefix + 'expand_BN')
            put('block13_depthwise', None, prefix + 'depthwise',
                prefix + 'depthwise_BN', depthwise=True)
            put('block13_project', None, prefix + 'project',
                prefix + 'project_BN')
            continue
        put(module, 'expand', prefix + 'expand', prefix + 'expand_BN')
        put(module, 'depthwise', prefix + 'depthwise',
            prefix + 'depthwise_BN', depthwise=True)
        put(module, 'project', prefix + 'project', prefix + 'project_BN')
    put('head', None, 'Conv_1', 'Conv_1_bn')
    return params, stats


def load_keras_mobilenet_v2(width_multiplier=1.0, weights=None,
                            input_size=224):
    """Build the Keras reference model (requires tensorflow)."""
    try:
        from tf_keras.applications import MobileNetV2
    except ImportError:
        from tensorflow.keras.applications import MobileNetV2
    return MobileNetV2(input_shape=(input_size, input_size, 3),
                       alpha=width_multiplier, include_top=False,
                       weights=weights)


def backbone_variables_from_keras(keras_model, dtype=None):
    """-> flax variables dict {'params': ..., 'batch_stats': ...} of numpy
    arrays (of ``dtype``, if given, for the parameters)."""
    params, stats = keras_mobilenet_v2_to_flax(keras_model)
    if dtype is not None:
        params = _cast_tree(params, dtype)
    return {'params': params, 'batch_stats': stats}


def _cast_tree(tree, dtype):
    """Every leaf of a nested dict as a numpy array of ``dtype``."""
    if isinstance(tree, dict):
        return {key: _cast_tree(value, dtype) for key, value in tree.items()}
    return np.asarray(tree, dtype)


# ---------------------------------------------------------------------------
# TF Object Detection API (slim naming) -> full SSD detector
# ---------------------------------------------------------------------------

_MOBILENET_ROOT = 'FeatureExtractor/MobilenetV2/'


class MissingVariable(KeyError):
    """A variable the SSD layout requires is absent from the checkpoint."""


def _slim_conv_bn(variables, scope, depthwise=False):
    """One slim conv+BN unit -> (params subtree, batch_stats subtree)."""
    weights_name = scope + ('/depthwise_weights' if depthwise
                            else '/weights')
    try:
        kernel = np.asarray(variables[weights_name])
        bn = {key: np.asarray(variables['{}/BatchNorm/{}'.format(scope, key)])
              for key in ('gamma', 'beta', 'moving_mean', 'moving_variance')}
    except KeyError as e:
        raise MissingVariable(str(e))
    if depthwise:
        # slim depthwise kernel [kh, kw, in, 1] -> flax grouped-conv
        # kernel [kh, kw, 1, in]
        kernel = np.transpose(kernel, (0, 1, 3, 2))
    return ({'Conv_0': {'kernel': kernel},
             'BatchNorm_0': {'scale': bn['gamma'], 'bias': bn['beta']}},
            {'BatchNorm_0': {'mean': bn['moving_mean'],
                             'var': bn['moving_variance']}})


def _slim_head(variables, scope):
    try:
        return {'kernel': np.asarray(variables[scope + '/weights']),
                'bias': np.asarray(variables[scope + '/biases'])}
    except KeyError as e:
        raise MissingVariable(str(e))


def _make_put(variables, params, stats):
    """Shared nested-path inserter for the slim mappers."""
    def put(path, scope, depthwise=False):
        p, s = _slim_conv_bn(variables, scope, depthwise)
        node_p, node_s = params, stats
        for part in path[:-1]:
            node_p = node_p.setdefault(part, {})
            node_s = node_s.setdefault(part, {})
        node_p[path[-1]] = p
        node_s[path[-1]] = s
    return put


def _put_heads(variables, params, n_layers):
    for i in range(n_layers):
        params['box_head{}'.format(i)] = _slim_head(
            variables, 'BoxPredictor_{}/BoxEncodingPredictor'.format(i))
        params['cls_head{}'.format(i)] = _slim_head(
            variables, 'BoxPredictor_{}/ClassPredictor'.format(i))


def tf_od_variables_to_flax(variables, config=None):
    """Map a TF-OD-API SSD-MobileNetV2 variable dict {name: array} to the
    flax variables tree of the SSD (models/ssd.py).

    ``config``: an SSDConfig (for the extras channel layout); defaults to
    the stock SSD300 configuration the public checkpoints use."""
    from watsor_tpu_torch.models.ssd import SSDConfig
    cfg = config if config is not None else SSDConfig()

    params = {}
    stats = {}
    put = _make_put(variables, params, stats)

    # backbone
    put(('backbone', 'stem'), _MOBILENET_ROOT + 'Conv')
    put(('backbone', 'block0', 'depthwise'),
        _MOBILENET_ROOT + 'expanded_conv/depthwise', depthwise=True)
    put(('backbone', 'block0', 'project'),
        _MOBILENET_ROOT + 'expanded_conv/project')
    for n in range(1, 17):
        scope = _MOBILENET_ROOT + 'expanded_conv_{}'.format(n)
        if n == 13:
            # the C4 tap: our backbone names block 13's stages explicitly
            put(('backbone', 'block13_expand'), scope + '/expand')
            put(('backbone', 'block13_depthwise'), scope + '/depthwise',
                depthwise=True)
            put(('backbone', 'block13_project'), scope + '/project')
            continue
        block = 'block{}'.format(n)
        put(('backbone', block, 'expand'), scope + '/expand')
        put(('backbone', block, 'depthwise'), scope + '/depthwise',
            depthwise=True)
        put(('backbone', block, 'project'), scope + '/project')
    put(('backbone', 'head'), _MOBILENET_ROOT + 'Conv_1')

    # extras ladder: layer_19_{1,2}_Conv2d_{2..5}; SSDLite checkpoints
    # (use_depthwise) split the 3x3 stage into _depthwise + 1x1 scopes
    lite = getattr(cfg, 'lite', False)
    for i, ch in enumerate(cfg.extra_features):
        put(('extra{}_pw'.format(i),),
            _MOBILENET_ROOT + 'layer_19_1_Conv2d_{}_1x1_{}'.format(
                i + 2, ch // 2))
        scope = _MOBILENET_ROOT + 'layer_19_2_Conv2d_{}_3x3_s2_{}'.format(
            i + 2, ch)
        if lite:
            put(('extra{}_dw'.format(i),), scope + '_depthwise',
                depthwise=True)
        put(('extra{}'.format(i),), scope)

    if lite:
        for i in range(cfg.anchor_spec.num_layers):
            for head, slim in (('box_head', 'BoxEncodingPredictor'),
                               ('cls_head', 'ClassPredictor')):
                put(('{}{}_dw'.format(head, i),),
                    'BoxPredictor_{}/{}_depthwise'.format(i, slim),
                    depthwise=True)
    _put_heads(variables, params, cfg.anchor_spec.num_layers)
    return {'params': params, 'batch_stats': stats}


_MOBILENET_V1_ROOT = 'FeatureExtractor/MobilenetV1/'


def tf_od_v1_variables_to_flax(variables, config=None):
    """Map a TF-OD-API SSD-MobileNetV1 variable dict (the slim layout of
    the public ``ssd_mobilenet_v1_coco_2018_01_28`` model.ckpt) to the
    flax tree of the ``backbone='mobilenet_v1'`` SSD::

        FeatureExtractor/MobilenetV1/Conv2d_0/...            -> stem
        FeatureExtractor/MobilenetV1/Conv2d_{n}_depthwise/...-> unitN_depthwise
        FeatureExtractor/MobilenetV1/Conv2d_{n}_pointwise/...-> unitN_pointwise
        .../Conv2d_13_pointwise_1_Conv2d_{i}_1x1_{c}         -> extra{i-2}_pw
        .../Conv2d_13_pointwise_2_Conv2d_{i}_3x3_s2_{c}      -> extra{i-2}
        BoxPredictor_{i}/...                                 -> heads
    """
    from watsor_tpu_torch.models.ssd import SSDConfig
    cfg = config if config is not None else SSDConfig(
        backbone='mobilenet_v1')
    assert cfg.backbone == 'mobilenet_v1'

    params = {}
    stats = {}
    put = _make_put(variables, params, stats)

    put(('backbone', 'stem'), _MOBILENET_V1_ROOT + 'Conv2d_0')
    for n in range(1, 14):
        put(('backbone', 'unit{}_depthwise'.format(n)),
            _MOBILENET_V1_ROOT + 'Conv2d_{}_depthwise'.format(n),
            depthwise=True)
        put(('backbone', 'unit{}_pointwise'.format(n)),
            _MOBILENET_V1_ROOT + 'Conv2d_{}_pointwise'.format(n))

    for i, ch in enumerate(cfg.extra_features):
        put(('extra{}_pw'.format(i),),
            _MOBILENET_V1_ROOT +
            'Conv2d_13_pointwise_1_Conv2d_{}_1x1_{}'.format(i + 2, ch // 2))
        put(('extra{}'.format(i),),
            _MOBILENET_V1_ROOT +
            'Conv2d_13_pointwise_2_Conv2d_{}_3x3_s2_{}'.format(i + 2, ch))

    _put_heads(variables, params, cfg.anchor_spec.num_layers)
    return {'params': params, 'batch_stats': stats}


_INCEPTION_ROOT = 'FeatureExtractor/InceptionV2/'


def tf_od_inception_variables_to_flax(variables, config=None):
    """Map a TF-OD-API SSD-InceptionV2 variable dict (the slim layout of
    the public ``ssd_inception_v2_coco_2018_01_28`` model.ckpt, the
    third column of the reference's model table) to the flax tree of the
    ``backbone='inception_v2'`` SSD::

        .../InceptionV2/Conv2d_1a_7x7/{depthwise,pointwise}_weights -> stem
        .../InceptionV2/Conv2d_2b_1x1, Conv2d_2c_3x3        -> conv2b/2c
        .../InceptionV2/Mixed_3b/Branch_0/Conv2d_0a_1x1 ... -> mixed_3b.b0 ...
        .../InceptionV2/Mixed_5c_1_Conv2d_{i}_1x1_{c}       -> extra{i-2}_pw
        .../InceptionV2/Mixed_5c_2_Conv2d_{i}_3x3_s2_{c}    -> extra{i-2}
        BoxPredictor_{i}/...                                -> heads
    """
    from watsor_tpu_torch.models.inception_v2 import INCEPTION_V2_BLOCKS
    from watsor_tpu_torch.models.ssd import SSDConfig
    cfg = config if config is not None else SSDConfig(
        backbone='inception_v2')
    assert cfg.backbone == 'inception_v2'

    params = {}
    stats = {}
    put = _make_put(variables, params, stats)

    # stem: ONE separable unit — depthwise + pointwise kernels share one
    # BatchNorm (slim separable_conv2d normalizes once, at the end)
    scope = _INCEPTION_ROOT + 'Conv2d_1a_7x7'
    try:
        dw = np.asarray(variables[scope + '/depthwise_weights'])
        pw = np.asarray(variables[scope + '/pointwise_weights'])
        bn = {key: np.asarray(variables['{}/BatchNorm/{}'.format(scope,
                                                                 key)])
              for key in ('gamma', 'beta', 'moving_mean',
                          'moving_variance')}
    except KeyError as e:
        raise MissingVariable(str(e))
    kh, kw, cin, mult = dw.shape          # [7, 7, 3, 8]
    params.setdefault('backbone', {})['stem'] = {
        # slim depthwise output channel (i, j) = input i, filter j — the
        # same group-major order lax grouped convs produce
        'dw': {'kernel': dw.reshape(kh, kw, 1, cin * mult)},
        'pw': {'kernel': pw},
        'BatchNorm_0': {'scale': bn['gamma'], 'bias': bn['beta']},
    }
    stats.setdefault('backbone', {})['stem'] = {
        'BatchNorm_0': {'mean': bn['moving_mean'],
                        'var': bn['moving_variance']}}

    put(('backbone', 'conv2b'), _INCEPTION_ROOT + 'Conv2d_2b_1x1')
    put(('backbone', 'conv2c'), _INCEPTION_ROOT + 'Conv2d_2c_3x3')

    for name, b0, b1, b2, b3, pool in INCEPTION_V2_BLOCKS:
        scope = _INCEPTION_ROOT + 'Mixed_' + name.split('_')[1] + '/'
        if b0 is None:        # reduction: two conv branches + maxpool
            put(('backbone', name, 'b0_0'),
                scope + 'Branch_0/Conv2d_0a_1x1')
            put(('backbone', name, 'b0_1'),
                scope + 'Branch_0/Conv2d_1a_3x3')
            put(('backbone', name, 'b1_0'),
                scope + 'Branch_1/Conv2d_0a_1x1')
            put(('backbone', name, 'b1_1'),
                scope + 'Branch_1/Conv2d_0b_3x3')
            put(('backbone', name, 'b1_2'),
                scope + 'Branch_1/Conv2d_1a_3x3')
        else:
            put(('backbone', name, 'b0'),
                scope + 'Branch_0/Conv2d_0a_1x1')
            put(('backbone', name, 'b1_0'),
                scope + 'Branch_1/Conv2d_0a_1x1')
            put(('backbone', name, 'b1_1'),
                scope + 'Branch_1/Conv2d_0b_3x3')
            put(('backbone', name, 'b2_0'),
                scope + 'Branch_2/Conv2d_0a_1x1')
            put(('backbone', name, 'b2_1'),
                scope + 'Branch_2/Conv2d_0b_3x3')
            put(('backbone', name, 'b2_2'),
                scope + 'Branch_2/Conv2d_0c_3x3')
            put(('backbone', name, 'b3'),
                scope + 'Branch_3/Conv2d_0b_1x1')

    for i, ch in enumerate(cfg.extra_features):
        put(('extra{}_pw'.format(i),),
            _INCEPTION_ROOT + 'Mixed_5c_1_Conv2d_{}_1x1_{}'.format(
                i + 2, ch // 2))
        put(('extra{}'.format(i),),
            _INCEPTION_ROOT + 'Mixed_5c_2_Conv2d_{}_3x3_s2_{}'.format(
                i + 2, ch))

    _put_heads(variables, params, cfg.anchor_spec.num_layers)
    return {'params': params, 'batch_stats': stats}


def infer_head_kernel(variables):
    """The predictors' conv size from the checkpoint's weight shapes
    (public v2 uses 3x3, public v1 uses 1x1)."""
    weights = variables.get('BoxPredictor_0/BoxEncodingPredictor/weights')
    if weights is None:
        raise MissingVariable('BoxPredictor_0/BoxEncodingPredictor/weights')
    return int(np.asarray(weights).shape[0])


def infer_num_classes(variables, anchors_layer0=3):
    """ClassPredictor_0 emits anchors * (num_classes + 1) channels; the
    lowest SSD layer has 3 anchors (reduce_boxes_in_lowest_layer)."""
    bias = variables.get('BoxPredictor_0/ClassPredictor/biases')
    if bias is None:
        raise MissingVariable('BoxPredictor_0/ClassPredictor/biases')
    per_anchor = np.asarray(bias).size // anchors_layer0
    return per_anchor - 1


def load_tf_checkpoint_variables(checkpoint_path):
    """Read every variable of a TF checkpoint (V1 or V2 format) into a
    plain {name: np.ndarray} dict. Accepts the ``model.ckpt`` prefix, the
    directory containing it, or a ``.index`` file path."""
    import tensorflow as tf
    import os
    path = checkpoint_path
    if os.path.isdir(path):
        latest = tf.train.latest_checkpoint(path)
        if latest is None:
            # the TF1 zoo tarballs ship model.ckpt.* without a
            # 'checkpoint' state file
            candidate = os.path.join(path, 'model.ckpt')
            if not tf.io.gfile.glob(candidate + '.index'):
                raise FileNotFoundError(
                    'no checkpoint found under {}'.format(path))
            latest = candidate
        path = latest
    elif path.endswith('.index'):
        path = path[:-len('.index')]
    reader = tf.train.load_checkpoint(path)
    names = reader.get_variable_to_shape_map().keys()
    return {name: reader.get_tensor(name) for name in names
            if 'Momentum' not in name and 'ExponentialMovingAverage'
            not in name and 'global_step' not in name}


def load_frozen_graph_variables(pb_path):
    """Read the Const tensors of a frozen inference graph (the
    reference's ``cpu.pb`` model file: its frozen_inference_graph.pb
    renamed) into a {name: np.ndarray} dict.

    Freezing turns every variable into a Const node that keeps the
    variable's name (FeatureExtractor/.../weights, .../BatchNorm/gamma,
    ...), so the result feeds the same slim mappers the checkpoints use."""
    import tensorflow as tf
    graph_def = tf.compat.v1.GraphDef()
    with open(pb_path, 'rb') as f:
        graph_def.ParseFromString(f.read())
    variables = {}
    for node in graph_def.node:
        if node.op != 'Const':
            continue
        try:
            value = tf.make_ndarray(node.attr['value'].tensor)
        except (ValueError, TypeError):
            continue
        if value.ndim >= 1:          # weights/BN vectors; skip shape scalars
            variables[node.name] = np.asarray(value)
    if not variables:
        raise ValueError('{} contains no constant tensors — not a frozen '
                         'inference graph'.format(pb_path))
    return variables


def resolve_model_source(path):
    """Classify a conversion source the way the reference's model folder
    is laid out: a ``.tflite`` graph, a ``.pb`` frozen graph, a TF1
    ``saved_model`` directory (variables under the slim names), or a
    checkpoint prefix/.index/dir."""
    import os
    if path.endswith('.tflite'):
        return 'tflite', path
    if path.endswith('.pb') and not os.path.basename(path).startswith(
            'saved_model'):
        return 'frozen_graph', path
    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, 'saved_model.pb')):
        return 'checkpoint', os.path.join(path, 'variables', 'variables')
    if os.path.basename(path) == 'saved_model.pb':
        return 'checkpoint', os.path.join(os.path.dirname(path),
                                          'variables', 'variables')
    return 'checkpoint', path


def convert_tf_od_checkpoint(checkpoint_path, config=None):
    """checkpoint -> (flax variables, SSDConfig). When ``config`` is None
    the backbone family (MobilenetV1/V2) and class count are inferred from
    the checkpoint's variable names and head shapes."""
    variables = load_tf_checkpoint_variables(checkpoint_path)
    return convert_tf_od_variables(variables, config)


def convert_tf_od_variables(variables, config=None):
    from watsor_tpu_torch.models.ssd import SSDConfig
    is_v1 = any(name.startswith(_MOBILENET_V1_ROOT) for name in variables)
    is_inception = any(name.startswith(_INCEPTION_ROOT)
                       for name in variables)
    lite_dw = 'BoxPredictor_0/BoxEncodingPredictor_depthwise/' \
              'depthwise_weights'
    is_lite = lite_dw in variables
    if is_lite and (is_v1 or is_inception):
        raise ValueError(
            'SSDLite predictors are only supported on the MobileNetV2 '
            'backbone (the v1/inception mappers cover the dense predictor '
            'layout only)')
    if config is None:
        if is_lite:
            head_kernel = int(np.asarray(variables[lite_dw]).shape[0])
        else:
            head_kernel = infer_head_kernel(variables)
        backbone = 'mobilenet_v2'
        if is_v1:
            backbone = 'mobilenet_v1'
        elif is_inception:
            backbone = 'inception_v2'
        config = SSDConfig(num_classes=infer_num_classes(variables),
                           head_kernel=head_kernel, lite=is_lite,
                           backbone=backbone)
    if config.backbone == 'mobilenet_v1':
        return tf_od_v1_variables_to_flax(variables, config), config
    if config.backbone == 'inception_v2':
        return tf_od_inception_variables_to_flax(variables, config), config
    return tf_od_variables_to_flax(variables, config), config


def main(argv=None):
    """CLI: TF checkpoint -> <name>.msgpack the zoo loads directly. Detects
    the model family from the checkpoint's variable names: TF-OD-API
    SSD-MobileNet (v1/v2/SSDLite) or automl EfficientDet-Lite.

    The reference's analog is dropping gpu.uff/cpu.pb model files into
    the model dir."""
    import argparse
    import logging
    parser = argparse.ArgumentParser(
        description='Convert a public detector checkpoint (TF-OD-API '
                    'SSD-MobileNet or automl EfficientDet-Lite) into '
                    'watsor-tpu-torch weights')
    parser.add_argument('-c', '--checkpoint', required=True,
                        help='model.ckpt prefix, .index file, directory, '
                             'a .tflite detection graph, a frozen .pb '
                             'graph, or a TF1 saved_model directory (the '
                             "reference's cpu.tflite/edgetpu.tflite/"
                             'cpu.pb/saved_model model files)')
    parser.add_argument('-o', '--output', required=True,
                        help='model directory to write into')
    parser.add_argument('-n', '--name', default=None,
                        help='weight file stem (zoo model name); default '
                             'follows the detected model family')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from watsor_tpu_torch.models.zoo import save_weights

    kind, source = resolve_model_source(args.checkpoint)
    if kind == 'tflite':
        from watsor_tpu_torch.models.convert_tflite import convert_tflite_ssd
        variables, config, anchors = convert_tflite_ssd(
            model_path=source)
        name = args.name
        if name is None:
            if config.backbone == 'mobilenet_v1':
                name = 'ssd_mobilenet_v1'
            elif config.backbone == 'inception_v2':
                name = 'ssd_inception_v2'
            elif config.lite:
                name = 'ssdlite_mobilenet_v2'
            else:
                name = 'ssd_mobilenet_v2'
        if anchors is not None:
            variables = dict(variables)
            variables['postprocess'] = {
                'anchors': anchors,
                'box_coder_scales': np.asarray(config.box_coder_scales,
                                               np.float32)}
        path = save_weights(variables, args.output, name)
        print('wrote {} ({} classes, input {}x{})'.format(
            path, config.num_classes, config.input_size, config.input_size))
        return

    if kind == 'frozen_graph':
        variables_in = load_frozen_graph_variables(source)
    else:
        variables_in = load_tf_checkpoint_variables(source)
    from watsor_tpu_torch.models.convert_effdet import (
        automl_effdet_variables_to_flax, infer_effdet_config,
        is_effdet_checkpoint)
    if is_effdet_checkpoint(variables_in):
        config = infer_effdet_config(variables_in)
        variables = automl_effdet_variables_to_flax(variables_in, config)
        name = args.name or 'efficientdet_{}'.format(config.variant)
    else:
        variables, config = convert_tf_od_variables(variables_in)
        name = args.name
        if name is None:             # default name follows the detection
            if config.backbone == 'mobilenet_v1':
                name = 'ssd_mobilenet_v1'
            elif config.backbone == 'inception_v2':
                name = 'ssd_inception_v2'
            elif getattr(config, 'lite', False):
                name = 'ssdlite_mobilenet_v2'
            else:
                name = 'ssd_mobilenet_v2'
    path = save_weights(variables, args.output, name)
    print('wrote {} ({} classes, input {}x{})'.format(
        path, config.num_classes, config.input_size, config.input_size))


if __name__ == '__main__':
    main()
