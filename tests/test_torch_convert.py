"""The port's weight converters (watsor_tpu_torch/models/convert.py,
convert_effdet.py, convert_tflite.py) against the JAX package's, on the
same inputs.

Seeded trees of every family at a small width (SSD-MobileNetV2 at width
0.35, SSDLite, MobileNetV1 at 0.25 with 1x1 predictors, InceptionV2,
EfficientDet-Lite0 with a 16-channel BiFPN under both fusion methods; 3
classes, the production extras) are named as the public checkpoints name
them by watsor_tpu_torch/testing/slim.py. The JAX converter maps each dict
back to its tree (the helper is the mappers' inverse); the port's mappers
give the JAX mappers' trees bit for bit, and the port's ``save_weights``
the JAX package's ``.msgpack`` bytes. The port's model on converted
weights meets the JAX model's raw outputs within the converter-parity
bound (5e-4 relative, BENCHMARKS.md "Parity proofs").

Where TensorFlow is installed, one real TF checkpoint goes through the
port's reader and CLI, and one real ``.tflite`` flatbuffer (a small Keras
SSD through the TFLite converter, with a TFLite_Detection_PostProcess op)
through ``convert_tflite_ssd`` and the CLI."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from watsor_tpu.models import convert as j_convert
from watsor_tpu.models import convert_effdet as j_effdet
from watsor_tpu.models import convert_tflite as j_tflite
from watsor_tpu.models.ssd import SSDConfig as JaxSSDConfig
from watsor_tpu.models.ssd import build_detector as jax_build_ssd
from watsor_tpu.models.zoo import save_weights as jax_save_weights
from watsor_tpu_torch.models import convert, convert_effdet, convert_tflite
from watsor_tpu_torch.models.efficientdet import build_effdet, lite_config
from watsor_tpu_torch.models.ssd import SSDConfig, anchors_for, build_detector
from watsor_tpu_torch.models.zoo import load_weights, save_weights
from watsor_tpu_torch.testing.slim import (automl_effdet_variables,
                                           tf_od_variables)

RAW_REL_TOL = 5e-4
SIZE = 96

SSD_RIGS = {
    'v2': SSDConfig(num_classes=3, width_multiplier=0.35),
    'ssdlite': SSDConfig(num_classes=3, width_multiplier=0.35, lite=True),
    'v1': SSDConfig(num_classes=3, backbone='mobilenet_v1',
                    width_multiplier=0.25, head_kernel=1),
    'inception': SSDConfig(num_classes=3, backbone='inception_v2'),
}
EFFDET = lite_config('lite0', num_classes=3, fpn_channels=16,
                     fpn_repeats=1, head_repeats=1)
EFFDET_RIGS = {'effdet_sum': EFFDET,
               'effdet_fastattn': EFFDET._replace(
                   fpn_weight_method='fastattn')}
RIGS = dict(SSD_RIGS, **EFFDET_RIGS)


def _seeded(tree, rng):
    """Every leaf replaced by seeded values of its shape (variances
    positive), so that a swapped or dropped leaf shows."""
    if isinstance(tree, dict):
        return {key: (_seeded(value, rng) if key != 'var' else
                      rng.uniform(0.5, 1.5, np.shape(value))
                      .astype(np.float32))
                for key, value in tree.items()}
    return (rng.normal(0.0, 0.1, np.shape(tree)) +
            (1.0 if np.ndim(tree) == 1 else 0.0)).astype(np.float32)


@pytest.fixture(scope='module')
def rigs():
    """{rig: (config, seeded flax tree, the checkpoint's {name: array})}."""
    out = {}
    for i, (name, cfg) in enumerate(RIGS.items()):
        effdet = name in EFFDET_RIGS
        build = build_effdet if effdet else build_detector
        tree = _seeded(build(cfg._replace(dtype=torch.float32),
                             device='cpu').variables,
                       np.random.default_rng(i))
        names = (automl_effdet_variables if effdet else tf_od_variables)(
            tree, cfg)
        out[name] = (cfg, tree, names)
    return out


def _assert_trees_equal(got, want, path=''):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for key in want:
            _assert_trees_equal(got[key], want[key], path + '/' + key)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def _fields(cfg):
    """A config's fields but the activation dtype (a torch or a jnp type)
    and the JAX EfficientDetConfig's TPU-only ``packing``."""
    return {key: tuple(value) if isinstance(value, tuple) else value
            for key, value in cfg._asdict().items()
            if key not in ('dtype', 'packing')}


def _jax_convert(name, cfg, names):
    if name in EFFDET_RIGS:
        return j_effdet.automl_effdet_variables_to_flax(names, cfg)
    return j_convert.convert_tf_od_variables(names, _jax_config(cfg))[0]


def _jax_config(cfg):
    """The JAX SSDConfig of ``cfg`` in f32 (the default anchor spec)."""
    fields = {key: value for key, value in cfg._asdict().items()
              if key not in ('dtype', 'anchor_spec')}
    return JaxSSDConfig(**fields, dtype=jnp.float32)


@pytest.mark.parametrize('rig', list(RIGS))
def test_jax_converter_inverts_the_slim_helper(rigs, rig):
    """The helper names the tree as the checkpoint does: the JAX
    package's converter maps its dict back to the seeded tree, bit for
    bit."""
    cfg, tree, names = rigs[rig]
    _assert_trees_equal(_jax_convert(rig, cfg, names), tree)


@pytest.mark.parametrize('rig', list(RIGS))
def test_port_converter_equals_the_jax_converter(rigs, rig, tmp_path):
    """The same tree, leaf for leaf and bit for bit, and the same
    ``.msgpack`` bytes through each package's ``save_weights``."""
    cfg, _, names = rigs[rig]
    want = _jax_convert(rig, cfg, names)
    if rig in EFFDET_RIGS:
        got = convert_effdet.automl_effdet_variables_to_flax(names, cfg)
    else:
        got, got_cfg = convert.convert_tf_od_variables(names, cfg)
        assert got_cfg is cfg
    _assert_trees_equal(got, want)
    mine = save_weights(got, str(tmp_path / 'port'), rig)
    theirs = jax_save_weights(want, str(tmp_path / 'jax'), rig)
    with open(mine, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()
    _assert_trees_equal(load_weights(str(tmp_path / 'port'), rig), want)


@pytest.mark.parametrize('rig', list(RIGS))
def test_port_infers_the_jax_geometry(rigs, rig):
    """With no config: the same family, class count, predictor kernel and
    SSDLite flag (the TF-OD mappers), or variant, FPN and head geometry,
    class count and fusion method (automl), as the JAX package infers."""
    _, _, names = rigs[rig]
    if rig in EFFDET_RIGS:
        got = convert_effdet.infer_effdet_config(names)
        want = j_effdet.infer_effdet_config(names)
        assert type(got) is type(EFFDET) and 'packing' not in got._fields
        assert got.fpn_weight_method == RIGS[rig].fpn_weight_method
    else:
        tree, got = convert.convert_tf_od_variables(names)
        want_tree, want = j_convert.convert_tf_od_variables(names)
        _assert_trees_equal(tree, want_tree)
        assert (got.backbone, got.lite, got.head_kernel) == \
            (RIGS[rig].backbone, RIGS[rig].lite, RIGS[rig].head_kernel)
    assert _fields(got) == _fields(want)
    assert got.num_classes == 3


def test_missing_variable_is_reported(rigs):
    _, _, names = rigs['v2']
    names = dict(names)
    del names['FeatureExtractor/MobilenetV2/expanded_conv_5/expand/weights']
    with pytest.raises(convert.MissingVariable, match='expanded_conv_5'):
        convert.convert_tf_od_variables(names)
    _, _, names = rigs['effdet_sum']
    names = {k: v for k, v in names.items() if 'resample_p6' not in k}
    with pytest.raises(convert.MissingVariable, match='resample_p6'):
        convert_effdet.infer_effdet_config(names)


def test_ssdlite_predictors_refuse_another_backbone(rigs):
    _, _, v1 = rigs['v1']
    _, _, lite = rigs['ssdlite']
    mixed = dict(v1)
    mixed.update({k: v for k, v in lite.items()
                  if k.startswith('BoxPredictor_0/BoxEncodingPredictor_')})
    with pytest.raises(ValueError, match='SSDLite'):
        convert.convert_tf_od_variables(mixed)


def test_port_model_on_converted_weights_meets_the_jax_model(rigs):
    """v2: the port's f32 model on its converted tree against the JAX
    package's on its converted tree, raw outputs within 5e-4 relative."""
    cfg, _, names = rigs['v2']
    cfg = cfg._replace(input_size=SIZE)
    tree, _ = convert.convert_tf_od_variables(names, cfg)
    jax_tree, _ = j_convert.convert_tf_od_variables(names, _jax_config(cfg))
    port = build_detector(cfg._replace(dtype=torch.float32), variables=tree,
                          device='cpu')
    jax_det = jax_build_ssd(_jax_config(cfg), params=jax_tree)
    images = np.random.default_rng(5).uniform(
        -1.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jax_det.raw_apply(jax_det.params,
                                                     jnp.asarray(images))]
    with torch.inference_mode():
        got = [a.numpy() for a in port.raw_apply(torch.from_numpy(images))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() / np.abs(w).max() < RAW_REL_TOL


def test_keras_backbone_mapping_casts_with_numpy():
    """``backbone_variables_from_keras``'s dtype cast, done with numpy in
    the port, on a stand-in Keras model: the JAX package's tree, leaves of
    the asked dtype."""
    from watsor_tpu_torch.models.mobilenet_v2 import MobileNetV2Backbone
    from watsor_tpu_torch.models.weights import export_variables
    tree = _seeded(export_variables(MobileNetV2Backbone(0.35)),
                   np.random.default_rng(9))
    model = _KerasStandIn(tree)
    got = convert.backbone_variables_from_keras(model, dtype=np.float16)
    want = j_convert.backbone_variables_from_keras(model, dtype=np.float16)
    _assert_trees_equal(got, want)
    assert got['params']['stem']['Conv_0']['kernel'].dtype == np.float16
    _assert_trees_equal(convert.backbone_variables_from_keras(model),
                        tree)


class _KerasStandIn:
    """The layers of a Keras MobileNetV2 by name, each with the weights
    ``get_weights`` returns, made from a flax backbone tree."""

    class _Layer:
        def __init__(self, name, weights):
            self.name = name
            self._weights = weights

        def get_weights(self):
            return self._weights

    def __init__(self, tree):
        params, stats = tree['params'], tree['batch_stats']
        self.layers = []

        def unit(module, conv, bn, depthwise=False):
            p, s = module
            kernel = p['Conv_0']['kernel']
            if depthwise:
                kernel = np.transpose(kernel, (0, 1, 3, 2))
            self.layers.append(self._Layer(conv, [kernel]))
            self.layers.append(self._Layer(bn, [
                p['BatchNorm_0']['scale'], p['BatchNorm_0']['bias'],
                s['BatchNorm_0']['mean'], s['BatchNorm_0']['var']]))

        def at(*path):
            return (_at(params, path), _at(stats, path))

        unit(at('stem'), 'Conv1', 'bn_Conv1')
        unit(at('block0', 'depthwise'), 'expanded_conv_depthwise',
             'expanded_conv_depthwise_BN', True)
        unit(at('block0', 'project'), 'expanded_conv_project',
             'expanded_conv_project_BN')
        for n in range(1, 17):
            prefix = 'block_{}_'.format(n)
            for stage in ('expand', 'depthwise', 'project'):
                path = ('block13_' + stage,) if n == 13 else \
                    ('block{}'.format(n), stage)
                unit(at(*path), prefix + stage, prefix + stage + '_BN',
                     stage == 'depthwise')
        unit(at('head'), 'Conv_1', 'Conv_1_bn')


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


# ---- with TensorFlow: a real checkpoint and a real .tflite ----------------

@pytest.fixture(scope='module')
def tf():
    return pytest.importorskip('tensorflow')


@pytest.fixture(scope='module')
def checkpoint(tf, rigs, tmp_path_factory):
    """The v2 rig's dict written as a genuine TF checkpoint (V2 format),
    as tests/test_convert_head.py writes its rig."""
    from tests.test_convert_head import _write_checkpoint
    _, _, names = rigs['v2']
    root = tmp_path_factory.mktemp('ckpt')
    _write_checkpoint(names, str(root / 'model.ckpt'))
    return root


def test_tf_checkpoint_reader(checkpoint, rigs):
    """``load_tf_checkpoint_variables`` reads every variable back, from the
    prefix, the ``.index`` file and the directory (the TF1 zoo tarballs
    have no 'checkpoint' state file)."""
    _, _, names = rigs['v2']
    prefix = str(checkpoint / 'model.ckpt')
    for source in (prefix, prefix + '.index', str(checkpoint)):
        got = convert.load_tf_checkpoint_variables(source)
        assert got.keys() == names.keys()
        for key in names:
            np.testing.assert_array_equal(got[key], names[key])


def test_tf_checkpoint_cli_writes_the_jax_bytes(checkpoint, tmp_path,
                                                capsys):
    """``python -m watsor_tpu_torch.models.convert -c <ckpt> -o <dir>``:
    the same file name and bytes as the JAX package's CLI."""
    prefix = str(checkpoint / 'model.ckpt')
    convert.main(['-c', prefix, '-o', str(tmp_path / 'port')])
    printed = capsys.readouterr().out
    j_convert.main(['-c', prefix, '-o', str(tmp_path / 'jax')])
    assert printed == capsys.readouterr().out.replace(
        str(tmp_path / 'jax'), str(tmp_path / 'port'))
    with open(tmp_path / 'port' / 'ssd_mobilenet_v2.msgpack', 'rb') as a, \
            open(tmp_path / 'jax' / 'ssd_mobilenet_v2.msgpack', 'rb') as b:
        assert a.read() == b.read()


def _keras_ssd(cfg, size):
    """A small Keras SSD-MobileNetV2 (tests/test_convert_head.py's rig at
    ``cfg``'s width and classes, ``size`` x ``size``)."""
    from tests.test_convert_head import _keras_layers
    from watsor_tpu_torch.ops.anchors import anchors_per_location
    layers, Model, MobileNetV2 = _keras_layers()
    backbone = MobileNetV2(input_shape=(size, size, 3), include_top=False,
                           alpha=cfg.width_multiplier, weights=None)
    feats = [backbone.get_layer('block_13_expand_relu').output,
             backbone.get_layer('out_relu').output]
    x = feats[1]
    for i, ch in enumerate(cfg.extra_features):
        x = layers.Conv2D(ch // 2, 1, use_bias=False)(x)
        x = layers.BatchNormalization(epsilon=1e-3)(x)
        x = layers.ReLU(max_value=6.0)(x)
        x = layers.Conv2D(ch, 3, strides=2, padding='same',
                          use_bias=False)(x)
        x = layers.BatchNormalization(epsilon=1e-3)(x)
        x = layers.ReLU(max_value=6.0)(x)
        feats.append(x)
    box_outs, cls_outs = [], []
    for feat, n in zip(feats, anchors_per_location(cfg.anchor_spec)):
        b = layers.Conv2D(n * 4, 3, padding='same')(feat)
        c = layers.Conv2D(n * (cfg.num_classes + 1), 3, padding='same')(feat)
        box_outs.append(layers.Reshape((-1, 4))(b))
        cls_outs.append(layers.Reshape((-1, cfg.num_classes + 1))(c))
    return Model(backbone.input, [layers.Concatenate(axis=1)(box_outs),
                                  layers.Concatenate(axis=1)(cls_outs)])


@pytest.fixture(scope='module')
def tflite_rig(tf):
    """(Keras model, raw .tflite, .tflite with the postprocess op, the
    anchors stored in it): a width-0.35, 3-class SSD at 96x96."""
    from tests.test_convert_head import _randomize
    from test_convert_tflite import _append_postprocess, _corners_to_center
    cfg = SSD_RIGS['v2']._replace(input_size=SIZE)
    model = _keras_ssd(cfg, SIZE)
    _randomize(model)
    raw = tf.lite.TFLiteConverter.from_keras_model(model).convert()
    anchors = anchors_for(cfg)
    detect = _append_postprocess(raw, _corners_to_center(anchors),
                                 cfg.num_classes)
    return model, raw, detect, anchors


def _tflite_pair(content):
    got = convert_tflite.convert_tflite_ssd(model_content=content)
    want = j_tflite.convert_tflite_ssd(model_content=content)
    _assert_trees_equal(got[0], want[0])
    assert _fields(got[1]) == _fields(want[1])
    if want[2] is None:
        assert got[2] is None
    else:
        np.testing.assert_array_equal(got[2], want[2])
    return got


def test_tflite_converts_as_the_jax_package(tflite_rig):
    """The detect.tflite layout: the JAX converter's tree, geometry,
    box-coder scales and stored anchors (corner form, the grid that was
    stored); the raw two-output export converts alike with no anchors."""
    _, raw, detect, anchors = tflite_rig
    tree, cfg, got_anchors = _tflite_pair(detect)
    assert (cfg.num_classes, cfg.head_kernel, cfg.lite, cfg.backbone) == \
        (3, 3, False, 'mobilenet_v2')
    assert tuple(cfg.box_coder_scales) == (10.0, 10.0, 5.0, 5.0)
    np.testing.assert_allclose(got_anchors, anchors, atol=1e-6)
    assert _tflite_pair(raw)[2] is None


def test_tflite_model_meets_keras_and_takes_the_stored_anchors(tflite_rig):
    """The port's f32 model on the converted tree: raw outputs against
    the Keras model's (BatchNorm folded by the TFLite converter; the bar
    of tests/test_convert_tflite.py), and ``build_detector`` takes the
    stored anchors as they are."""
    model, _, detect, _ = tflite_rig
    tree, cfg, anchors = convert_tflite.convert_tflite_ssd(
        model_content=detect)
    # the flatbuffer does not carry the width; the graph's is 0.35
    det = build_detector(cfg._replace(dtype=torch.float32, input_size=SIZE,
                                      width_multiplier=0.35),
                         variables=tree, anchors=anchors, device='cpu')
    np.testing.assert_array_equal(det.anchors, anchors)
    image = np.random.default_rng(7).uniform(
        -1.0, 1.0, (1, SIZE, SIZE, 3)).astype(np.float32)
    want = [a.numpy() for a in model(image, training=False)]
    with torch.inference_mode():
        got = [a.numpy() for a in det.raw_apply(torch.from_numpy(image))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=2e-3)


def test_tflite_cli_writes_the_jax_bytes(tflite_rig, tmp_path):
    """The CLI on a .tflite: the weights with the postprocess sidecar
    (anchors and box-coder scales), the JAX CLI's bytes."""
    _, _, detect, anchors = tflite_rig
    path = str(tmp_path / 'cpu.tflite')
    with open(path, 'wb') as f:
        f.write(detect)
    convert.main(['-c', path, '-o', str(tmp_path / 'port')])
    j_convert.main(['-c', path, '-o', str(tmp_path / 'jax')])
    name = 'ssd_mobilenet_v2.msgpack'
    with open(tmp_path / 'port' / name, 'rb') as a, \
            open(tmp_path / 'jax' / name, 'rb') as b:
        assert a.read() == b.read()
    stored = load_weights(str(tmp_path / 'port'), 'ssd_mobilenet_v2')
    np.testing.assert_allclose(stored['postprocess']['anchors'], anchors,
                               atol=1e-6)


def test_model_source_resolution(tmp_path):
    """``resolve_model_source`` classifies the reference's model files as
    the JAX package's does."""
    saved = tmp_path / 'saved'
    saved.mkdir()
    (saved / 'saved_model.pb').write_bytes(b'')
    for path in ('cpu.tflite', 'cpu.pb', str(saved),
                 str(saved / 'saved_model.pb'), 'model.ckpt'):
        assert convert.resolve_model_source(path) == \
            j_convert.resolve_model_source(path)
    assert convert.resolve_model_source(str(saved))[1] == os.path.join(
        str(saved), 'variables', 'variables')
