"""The port's SSD-MobileNetV2 against the JAX package's, on the JAX
package's own PRNGKey(0) weights carried across by the weight bridge.

Bars (f32 unless stated):
  - raw (box_enc, logits) against ``Detector.raw_apply``: under 5e-4
    relative to the output's magnitude, the converter-parity bar of
    BENCHMARKS.md "Parity proofs";
  - the fused walk (bf16 inside its blocks) against the flax model: 5e-3
    absolute, the bar of tests/test_ssd_fused.py;
  - detect_batch on uint8 frames: labels and counts equal, boxes and
    scores within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.models.ssd import SSDConfig as JaxConfig
from watsor_tpu.models.ssd import build_detector as jax_build
from watsor_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
from watsor_tpu_torch.models.ssd_fused import (build_folded_pack,
                                               build_fused_detector)
from watsor_tpu_torch.models.weights import export_variables, load_npz
from watsor_tpu_torch.models.zoo import build_from_zoo
from watsor_tpu_torch.ops.preprocess import preprocess_batch

RAW_REL_TOL = 5e-4
FUSED_ATOL = 5e-3
DETECT_TOL = 1e-4
SIZE = 96


@pytest.fixture(scope='module')
def pair():
    """(JAX detector, the port's detector on the same weights)."""
    jax_det = jax_build(JaxConfig(num_classes=3, input_size=SIZE,
                                  dtype=jnp.float32,
                                  nms_mode='fused_exact'))
    variables = jax.tree_util.tree_map(np.asarray, jax_det.params)
    port = build_detector(SSDConfig(num_classes=3, input_size=SIZE,
                                    dtype=torch.float32,
                                    nms_mode='fused_exact'),
                          variables=variables)
    return jax_det, port


@pytest.fixture(scope='module')
def images():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, SIZE, SIZE, 3), np.uint8)
    want = jax_preprocess(jnp.asarray(u8), SIZE, SIZE, dtype=jnp.float32)
    got = preprocess_batch(torch.from_numpy(u8), SIZE, SIZE,
                           dtype=torch.float32)
    return want, got


@pytest.fixture(scope='module')
def jax_raw(pair, images):
    jax_det, _ = pair
    return [np.asarray(a) for a in jax_det.raw_apply(jax_det.params,
                                                     images[0])]


def test_raw_outputs_match_flax(pair, images, jax_raw):
    _, port = pair
    with torch.inference_mode():
        got = [a.numpy() for a in port.raw_apply(images[1])]
    for g, w in zip(got, jax_raw):
        assert g.shape == w.shape
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel < RAW_REL_TOL, rel


def test_fused_walk_matches_flax(pair, images, jax_raw):
    _, port = pair
    fused = build_fused_detector(port)
    with torch.inference_mode():
        got = [a.numpy() for a in fused.raw_apply(images[1])]
    for g, w in zip(got, jax_raw):
        np.testing.assert_allclose(g, w, rtol=0, atol=FUSED_ATOL)


def test_fused_pack_holds_the_kernel_operands(pair):
    """The CUDA kernel takes contiguous bf16 weights and f32 biases, cast
    once when the pack is built."""
    _, port = pair
    # the exported tree holds transposed (Fortran-ordered) views
    pack = build_folded_pack(export_variables(port.model), port.config,
                             torch.device('cpu'))
    blocks = [v for v in pack.values() if isinstance(v, dict)]
    assert len(blocks) == 12
    for block in blocks:
        for name, t in block.items():
            assert t.is_contiguous(), name
            assert t.dtype == (torch.bfloat16 if name.startswith('w')
                               else torch.float32), name


def test_detect_batch_matches_jax(pair):
    jax_det, port = pair
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, 120, 160, 3), np.uint8)
    want = [np.asarray(a) for a in jax_det.detect_batch(
        jax_det.params, jnp.asarray(frames))]
    got = [a.numpy() for a in port.detect_batch(torch.from_numpy(frames))]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=DETECT_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DETECT_TOL)


def test_active_labels_match_jax(pair):
    """Watching labels {1, 3}: the NMS class axis shrinks to two and the
    labels map back to 1-based indices, as in the JAX package."""
    jax_det, port = pair
    jax_sub = jax_build(jax_det.config._replace(active_labels=(1, 3)),
                        params=jax_det.params)
    port_sub = build_detector(port.config._replace(active_labels=(1, 3)),
                              variables=port.variables)
    frames = np.random.default_rng(2).integers(0, 256, (1, SIZE, SIZE, 3),
                                               np.uint8)
    want = [np.asarray(a) for a in jax_sub.detect_batch(
        jax_sub.params, jnp.asarray(frames))]
    got = [a.numpy() for a in port_sub.detect_batch(
        torch.from_numpy(frames))]
    assert set(got[2][got[2] > 0].tolist()) <= {1, 3}
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DETECT_TOL)


@pytest.mark.parametrize('mode', ['exact', 'fast'])
def test_per_class_detect_batch_matches_jax(pair, mode):
    """``nms: exact`` (and ``fast``): every anchor decoded, f32 sigmoid over
    the watched columns, per-class NMS and the label remap, as in the JAX
    package: labels and counts equal, boxes and scores within 1e-4."""
    jax_det, port = pair
    cfg = jax_det.config._replace(nms_mode=mode, active_labels=(1, 3))
    jax_sub = jax_build(cfg, params=jax_det.params)
    port_sub = build_detector(port.config._replace(nms_mode=mode,
                                                   active_labels=(1, 3)),
                              variables=port.variables)
    frames = np.random.default_rng(5).integers(0, 256, (2, 120, 160, 3),
                                               np.uint8)
    want = [np.asarray(a) for a in jax_sub.detect_batch(
        jax_sub.params, jnp.asarray(frames))]
    got = [a.numpy() for a in port_sub.detect_batch(
        torch.from_numpy(frames))]
    assert (want[3] > 0).all()
    assert set(got[2][got[2] > 0].tolist()) <= {1, 3}
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=DETECT_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DETECT_TOL)


def test_unknown_nms_mode_raises():
    with pytest.raises(ValueError, match='unknown nms mode'):
        build_detector(SSDConfig(num_classes=3, input_size=SIZE,
                                 nms_mode='soft'))


def test_bridge_round_trips_the_variables_tree(pair):
    _, port = pair
    exported = export_variables(port.model)
    flat_want = jax.tree_util.tree_leaves_with_path(port.variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(exported))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_zoo_loads_npz_weights(pair, tmp_path):
    """An .npz in the JAX package's flat layout is adopted, with the
    class count read from the stored heads."""
    _, port = pair
    flat = {'/'.join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(port.variables)}
    np.savez(tmp_path / 'ssd_mobilenet_v2.npz', **flat)
    assert load_npz(tmp_path / 'ssd_mobilenet_v2.npz').keys() == \
        {'params', 'batch_stats'}
    loaded = build_from_zoo('ssd_mobilenet_v2', str(tmp_path),
                            dtype=torch.float32)
    assert loaded.config.num_classes == 3
    np.testing.assert_array_equal(
        loaded.variables['params']['cls_head0']['bias'],
        port.variables['params']['cls_head0']['bias'])


def test_zoo_refuses_unported_models():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        build_from_zoo('efficientdet_lite0')
