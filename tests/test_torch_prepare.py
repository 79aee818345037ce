"""The port's shape-model preparation (watsor_tpu_torch/testing/prepare.py)
and its ``.msgpack`` writer (models/msgpack.py ``to_bytes``, models/zoo.py
``save_weights``) against the JAX package: the same painted and labelled
batches from the same seed, the bytes flax writes, and a shape model
trained by the port that the JAX package loads and runs to the port's raw
outputs within 5e-4 relative (f32)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from watsor_tpu.models.ssd import build_detector as jax_build_detector
from watsor_tpu.models.zoo import load_weights as jax_load_weights
from watsor_tpu.models.zoo import save_weights as jax_save_weights
from watsor_tpu.testing.prepare import generate_batch as jax_generate_batch
from watsor_tpu.testing.prepare import make_shape_config as \
    jax_make_shape_config
from watsor_tpu_torch.models import msgpack
from watsor_tpu_torch.models.ssd import build_detector
from watsor_tpu_torch.models.zoo import (load_weights, model_config,
                                         save_weights)
from watsor_tpu_torch.testing import prepare
from watsor_tpu_torch.testing.prepare import (SHAPE_MODEL, generate_batch,
                                              make_shape_config)
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

RAW_REL_TOL = 5e-4



@pytest.mark.parametrize('seed', [0, 7])
def test_generate_batch_matches_jax(seed):
    got = generate_batch(6, (96, 80), seed=seed)
    want = jax_generate_batch(6, (96, 80), seed=seed)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got['gt_valid'].any()


def _writer_tree():
    """Every header width the weights meet: maps of 16 keys and more, keys
    of 32 bytes and more, arrays of more than 255 and 65535 bytes, shapes
    with dimensions over 127, 255 and 65535, a 0-d array (a 16-byte
    payload: fixext 16), an empty dict, every dtype the reader takes but
    bfloat16, a transposed (non-contiguous) array; keys out of order."""
    rng = np.random.default_rng(0)
    tree = {'z': {'kernel': rng.normal(size=(3, 3, 8, 4)).astype(np.float32),
                  'bias': rng.normal(size=4).astype(np.float32)},
            'k' * 40: {str(i): rng.integers(0, 255, i + 1).astype(np.uint8)
                       for i in range(20)},
            'scalar': np.array(1.5, np.float32),
            'wide': np.zeros((1, 300, 70000), np.uint8),
            'mid': rng.normal(size=(130, 300)).astype(np.float16),
            'transposed': np.arange(12, dtype=np.float32).reshape(3, 4).T,
            'empty': {},
            'none': np.zeros((0, 3), np.float32),
            'a': {name: rng.integers(0, 2, 5).astype(name)
                  for name in msgpack.READ_DTYPES if name != 'bfloat16'}}
    return tree


def test_writer_equals_flax_to_bytes():
    tree = _writer_tree()
    data = msgpack.to_bytes(tree)
    assert data == serialization.to_bytes(tree)
    back = msgpack.restore(data)
    np.testing.assert_array_equal(back['transposed'], tree['transposed'])
    assert list(back) == list(tree)


@pytest.mark.parametrize('leaf,error', [
    (np.zeros(3, np.complex64), 'complex64'),
    (np.zeros(3, '>f4'), 'big-endian'),
    (np.broadcast_to(np.zeros(1, np.float32), (2 ** 28 + 1,)), 'chunks'),
    (np.float32(1.0), 'float32'),
    ([1, 2], 'list')])
def test_writer_refuses_what_it_cannot_write_faithfully(leaf, error):
    with pytest.raises((ValueError, TypeError), match=error):
        msgpack.to_bytes({'leaf': leaf})
    with pytest.raises(TypeError, match='str keys'):
        msgpack.to_bytes({1: np.zeros(2, np.float32)})


def test_save_weights_writes_the_jax_packages_bytes(tmp_path):
    """The same variables tree (keys out of order) through the port's
    save_weights and the JAX package's: the same file."""
    tree = {'params': {'b': {'kernel': np.ones((1, 1, 2, 2), np.float32)},
                       'a': {'bias': np.arange(3, dtype=np.float32)}},
            'batch_stats': {'a': {'var': np.ones(3, np.float32),
                                  'mean': np.zeros(3, np.float32)}}}
    got = save_weights(tree, str(tmp_path / 'port'), 'm')
    want = jax_save_weights(tree, str(tmp_path / 'jax'), 'm')
    assert os.path.basename(got) == 'm.msgpack'
    with open(got, 'rb') as f, open(want, 'rb') as g:
        assert f.read() == g.read()


def test_shape_model_geometry_is_the_jax_trainers():
    cfg, want = make_shape_config(), jax_make_shape_config()
    for field in ('num_classes', 'input_size', 'width_multiplier',
                  'extra_features', 'backbone', 'lite', 'head_kernel'):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.dtype == torch.float32
    # the zoo's entry of that name is the 300x300 width-1.0 geometry, as
    # in the JAX registry
    zoo = model_config(SHAPE_MODEL)
    assert (zoo.input_size, zoo.width_multiplier, zoo.num_classes) == \
        (300, 1.0, 3)


def test_a_port_trained_shape_model_runs_in_jax(tmp_path):
    """Two training steps on the CPU through the command line, saved into
    the zoo: the JAX package's load_weights reads the file, and its
    detector on those weights gives the port's raw outputs."""
    model_dir = str(tmp_path)
    prepare.main(['--steps', '2', '--batch', '4', '--out', model_dir,
                  '--device', 'cpu'])
    tree = jax_load_weights(model_dir, SHAPE_MODEL)
    ours = load_weights(model_dir, SHAPE_MODEL)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(ours)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(ours)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jax_det = jax_build_detector(jax_make_shape_config(), params=tree)
    port = build_detector(make_shape_config(), variables=ours,
                          device='cpu')
    assert port.config.input_size == 96 and port.config.num_classes == 3
    images = np.random.default_rng(1).uniform(
        -1, 1, (2, 96, 96, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(jax_det.raw_apply)(
        jax_det.params, jnp.asarray(images))]
    with torch.inference_mode():
        got = [a.numpy() for a in port.raw_apply(torch.from_numpy(images))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= RAW_REL_TOL * np.abs(w).max()
