"""The port's reader of flax ``.msgpack`` weight files
(watsor_tpu_torch/models/msgpack.py) against flax's own
``msgpack_restore``, and the zoo loading the files that the JAX package's
``save_weights`` writes, without flax or the ``msgpack`` package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from watsor_tpu.models.zoo import save_weights
from watsor_tpu_torch.models.efficientdet import build_effdet
from watsor_tpu_torch.models.msgpack import load_msgpack, restore
from watsor_tpu_torch.models.ssd import build_detector
from watsor_tpu_torch.models.zoo import build_from_zoo, model_config
from tests.test_torch_golden import golden_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_same(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, path
            assert g.shape == w.shape, path
            np.testing.assert_array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w, path


def test_reader_equals_flax_msgpack_restore():
    """Nested maps, arrays of every dtype the reader takes, numpy and
    Python scalars of every msgpack width, strings, bytes and lists."""
    rng = np.random.default_rng(0)
    tree = {'params': {
        'conv': {'kernel': rng.normal(size=(3, 3, 1, 8)).astype(np.float32),
                 'bias': rng.normal(size=8).astype(np.float64)},
        'empty': np.zeros((0, 4), np.float32),
        'half': rng.normal(size=5).astype(np.float16),
        'flags': np.array([True, False]),
        'ints': {str(dt): rng.integers(0, 100, 7).astype(dt)
                 for dt in ('int8', 'int16', 'int32', 'int64', 'uint8',
                            'uint16', 'uint32', 'uint64')}},
        'scalars': {'np_f32': np.float32(1.5), 'np_i64': np.int64(-3),
                    'ints': [0, 127, 128, 255, 65536, 2 ** 32 + 1, -1, -33,
                             -129, -40000, -2 ** 40, 2 ** 63],
                    'floats': [0.5, -1e300], 'text': 'a' * 40 + 'é',
                    'long_text': 'x' * 70000, 'raw': b'\x00\xff',
                    'flag': True, 'complex': 1 + 2j},
        'list': list(range(20))}
    data = serialization.msgpack_serialize(tree)
    _assert_same(restore(data), serialization.msgpack_restore(data))


def test_int8_leaf_reads_as_int8():
    q = np.random.default_rng(1).integers(-127, 128, (1, 1, 16, 24)) \
        .astype(np.int8)
    got = restore(serialization.to_bytes({'kernel': q, 'scale': np.ones(
        24, np.float32)}))
    assert got['kernel'].dtype == np.int8
    np.testing.assert_array_equal(got['kernel'], q)


def test_bfloat16_leaf_widens_exactly_to_f32():
    x = jnp.asarray([1.0, -2.5, 3.140625, 1e-3, 65280.0], jnp.bfloat16)
    got = restore(serialization.to_bytes({'x': np.asarray(x)}))['x']
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_chunked_arrays_join_back(monkeypatch):
    """flax splits a leaf over MAX_CHUNK_SIZE bytes into chunks."""
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    x = np.arange(100, dtype=np.float32).reshape(4, 25)
    data = serialization.msgpack_serialize({'big': x})
    assert b'__msgpack_chunked_array__' in data
    np.testing.assert_array_equal(restore(data)['big'], x)


def test_unread_dtype_raises_naming_it():
    data = serialization.to_bytes({'z': np.zeros(3, np.complex64)})
    with pytest.raises(ValueError, match='complex64'):
        restore(data)


def test_truncated_file_raises():
    data = serialization.to_bytes({'k': np.zeros(8, np.float32)})
    with pytest.raises(ValueError, match='ends inside'):
        restore(data[:-5])


@pytest.mark.parametrize('name', ['ssd_mobilenet_v1', 'efficientdet_lite0'])
def test_zoo_builds_from_the_jax_packages_msgpack(name, tmp_path):
    """save_weights (flax.serialization.to_bytes) -> the port's
    build_from_zoo: the same leaves, and the same detections as the port
    built on the tree itself. A stale .npz beside the .msgpack is
    ignored: .msgpack takes precedence, as in the JAX package."""
    tree = golden_tree(name)
    save_weights(tree, str(tmp_path), name)
    np.savez(tmp_path / (name + '.npz'), **{'params/stale': np.zeros(1)})
    _assert_same(load_msgpack(tmp_path / (name + '.msgpack')), tree)
    loaded = build_from_zoo(name, str(tmp_path), dtype=torch.float32,
                            device='cpu')
    for path, leaf in _leaves(tree):
        got = loaded.variables
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf)
    cfg = model_config(name)._replace(dtype=torch.float32)
    build = build_effdet if name.startswith('efficientdet_') else \
        build_detector
    direct = build(cfg, variables=tree, device='cpu')
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (1, 120, 160, 3), np.uint8))
    for got, want in zip(loaded.detect_batch(frames),
                         direct.detect_batch(frames)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_the_reader_needs_neither_flax_nor_msgpack(tmp_path):
    """The card's machine has neither: read a file in a process where
    both imports fail."""
    path = tmp_path / 'w.msgpack'
    path.write_bytes(serialization.to_bytes(
        {'params': {'a': np.arange(6, dtype=np.float32).reshape(2, 3)}}))
    code = ('import sys\n'
            "sys.modules['flax'] = sys.modules['msgpack'] = None\n"
            'from watsor_tpu_torch.models.msgpack import load_msgpack\n'
            "print(load_msgpack(sys.argv[1])['params']['a'].sum())\n")
    proc = subprocess.run([sys.executable, '-c', code, str(path)],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == '15.0'
