"""The port's other detector families against the JAX package's, at small
size, on the JAX package's PRNGKey(0) trees carried across by the weight
bridge. Every BatchNorm's parameters and statistics, every bias and the
fast-attention weights are redrawn from a numpy seed first (flax
initializes them to constants, which would hide a swapped leaf).

Families: SSD on MobileNetV1 (width 0.25), SSDLite on MobileNetV2 (width
0.35), SSD on InceptionV2, SSD on MobileNetV2 at width 0.5, each at 128x128
with narrow extras; EfficientDet-Lite0 and -Lite2 with fpn_channels=16,
fpn_repeats=1, head_repeats=1 at 128x128, and Lite0 at 160x160 with
fast-attention fusion, where P7 -> P6 is 2 -> 3 and P6 -> P5 is 3 -> 5 (a
nearest upsample at a ratio other than 2).

Bars (f32): raw (box_enc, logits) within 5e-4 relative to the output's
magnitude, the converter-parity bar of BENCHMARKS.md "Parity proofs";
detect_batch on uint8 frames under ``fused_exact`` and ``exact``: labels
and counts equal, boxes and scores within 1e-4 (tests/test_torch_model.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.models.efficientdet import EfficientDet as JaxEfficientDet
from watsor_tpu.models.efficientdet import build_effdet as jax_build_effdet
from watsor_tpu.models.efficientdet import lite_config as jax_lite_config
from watsor_tpu.models.ssd import SSD as JaxSSD
from watsor_tpu.models.ssd import SSDConfig as JaxSSDConfig
from watsor_tpu.models.ssd import build_detector as jax_build_ssd
from watsor_tpu_torch.models.efficientdet import (build_effdet, lite_config,
                                                  upsample_nearest)
from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
from watsor_tpu_torch.models.weights import export_variables
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

RAW_REL_TOL = 5e-4
DETECT_TOL = 1e-4
SIZE = 128
EXTRAS = (64, 32, 32, 16)
EFFDET_SMALL = dict(num_classes=3, fpn_channels=16, fpn_repeats=1,
                    head_repeats=1, input_size=SIZE)

# family -> (SSD overrides or None, EfficientDet variant and overrides)
FAMILIES = {
    'ssd_mobilenet_v1': dict(backbone='mobilenet_v1', width_multiplier=0.25,
                             head_kernel=1),
    'ssdlite_mobilenet_v2': dict(lite=True, width_multiplier=0.35),
    'ssd_inception_v2': dict(backbone='inception_v2'),
    'ssd_mobilenet_v2_w050': dict(width_multiplier=0.5),
    'efficientdet_lite0': ('lite0', {}),
    'efficientdet_lite2': ('lite2', {}),
    'efficientdet_lite0_160_fastattn': ('lite0', dict(
        input_size=160, fpn_weight_method='fastattn')),
}


def _configs(family, nms_mode):
    """(JAX config, port config) in f32."""
    spec = FAMILIES[family]
    if isinstance(spec, dict):
        common = dict(num_classes=3, input_size=SIZE, extra_features=EXTRAS,
                      nms_mode=nms_mode, **spec)
        return (JaxSSDConfig(dtype=jnp.float32, **common),
                SSDConfig(dtype=torch.float32, **common))
    variant, overrides = spec
    common = dict(EFFDET_SMALL, nms_mode=nms_mode, **overrides)
    return (jax_lite_config(variant, dtype=jnp.float32, **common),
            lite_config(variant, dtype=torch.float32, **common))


def _build(family, nms_mode, tree=None):
    """(JAX detector, the port's detector) on the same weights; without
    ``tree``, the JAX PRNGKey(0) tree with its constants redrawn."""
    jax_cfg, cfg = _configs(family, nms_mode)
    effdet = not isinstance(FAMILIES[family], dict)
    jax_build = jax_build_effdet if effdet else jax_build_ssd
    if tree is None:
        # build_detector's and build_effdet's PRNGKey(0) init, compiled
        model = (JaxEfficientDet if effdet else JaxSSD)(jax_cfg)
        dummy = jnp.zeros((1, cfg.input_size, cfg.input_size, 3),
                          jnp.float32)
        init = jax.jit(model.init)(jax.random.PRNGKey(0), dummy)
        tree = _redraw(jax.tree_util.tree_map(np.asarray, init),
                       np.random.default_rng(0))
    jax_det = jax_build(jax_cfg, params=tree)
    port = (build_effdet if effdet else build_detector)(
        cfg, variables=tree, device='cpu')
    return jax_det, port


def _redraw(node, rng, key=None):
    """The tree with BN scales, variances, biases, means and WSM weights
    drawn from ``rng``; kernels kept."""
    if isinstance(node, dict):
        return {k: _redraw(v, rng, k) for k, v in sorted(node.items())}
    if key in ('scale', 'var', 'WSM'):
        return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
    if key in ('bias', 'mean'):
        return rng.normal(0.0, 0.1, node.shape).astype(np.float32)
    return node


@pytest.fixture(scope='module', params=sorted(FAMILIES))
def pair(request):
    return (request.param,) + _build(request.param, 'fused_exact')


def _raw(jax_det, port, images):
    want = [np.asarray(a) for a in jax.jit(jax_det.raw_apply)(
        jax_det.params, jnp.asarray(images))]
    with torch.inference_mode():
        got = [a.numpy() for a in port.raw_apply(torch.from_numpy(images))]
    return got, want


def test_raw_outputs_match_jax(pair):
    family, jax_det, port = pair
    size = port.config.input_size
    images = np.random.default_rng(1).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)
    got, want = _raw(jax_det, port, images)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel < RAW_REL_TOL, (family, rel)


def _detect(detector, frames, jax_params=None):
    if jax_params is not None:
        out = detector.detect_batch(jax_params, jnp.asarray(frames))
    else:
        out = detector.detect_batch(torch.from_numpy(frames))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize('mode', ['fused_exact', 'exact'])
def test_detect_batch_matches_jax(pair, mode):
    """The uint8-in -> detections-out step: labels and counts equal,
    boxes and scores within DETECT_TOL."""
    family, jax_det, port = pair
    if mode != 'fused_exact':
        jax_det, port = _build(family, mode, tree=jax_det.params)
    frames = np.random.default_rng(2).integers(0, 256, (2, 120, 160, 3),
                                               np.uint8)
    want = _detect(jax_det, frames, jax_det.params)
    got = _detect(port, frames)
    assert (want[3] > 0).all()
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=DETECT_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DETECT_TOL)


def test_bridge_round_trips_the_variables_tree(pair):
    """The family's flax tree loads into the port and exports back
    unchanged, leaf for leaf (EfficientDet's shared head convolutions
    once, its per-level BatchNorms each)."""
    _, jax_det, port = pair
    want = dict(jax.tree_util.tree_leaves_with_path(jax_det.params))
    got = dict(jax.tree_util.tree_leaves_with_path(
        export_variables(port.model)))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)


def test_fused_heads_equal_the_two_heads():
    """WATSOR_FUSED_HEADS: the two-head tree fused into one twice-wide,
    block-diagonal stack gives the two-head outputs within the f32 bar."""
    _, cfg = _configs('efficientdet_lite0', 'fused_exact')
    tree = _redraw(export_variables(build_effdet(cfg, device='cpu').model),
                   np.random.default_rng(4))
    port = build_effdet(cfg, variables=tree, device='cpu')
    fused = build_effdet(cfg._replace(fused_heads=True), variables=tree,
                         device='cpu')
    assert 'dual_head' in fused.variables['params']
    images = np.random.default_rng(3).uniform(
        -1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    x = torch.from_numpy(images)
    with torch.inference_mode():
        want = port.raw_apply(x)
        got = fused.raw_apply(x)
    for g, w in zip(got, want):
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel < RAW_REL_TOL, rel


@pytest.mark.parametrize('family', ['ssd_mobilenet_v1', 'efficientdet_lite0'])
def test_anchor_override_must_match_the_head_geometry(family):
    """A postprocess sidecar's anchors of another shape than the heads'
    raise, as build_detector and build_effdet do in the JAX package."""
    _, cfg = _configs(family, 'fused')
    build = build_detector if isinstance(cfg, SSDConfig) else build_effdet
    good = build(cfg, device='cpu').anchors
    assert build(cfg, anchors=good + 0.01, device='cpu').anchors.shape == \
        good.shape
    with pytest.raises(ValueError, match='anchor override shape'):
        build(cfg, anchors=good[:-1], device='cpu')


def test_upsample_matches_jax_nearest_resize():
    """3 -> 5 and 4 -> 7 read as jax.image.resize 'nearest' does (torch's
    'nearest' reads [0, 0, 1, 1, 2] at 3 -> 5); 2x is a repeat."""
    for n, m in ((3, 5), (4, 7), (5, 10), (2, 3)):
        x = np.arange(n * n, dtype=np.float32).reshape(1, n, n, 1)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, m, m, 1),
                                           method='nearest'))
        got = upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), m, m)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize('family', ['ssd_mobilenet_v1',
                                    'ssdlite_mobilenet_v2'])
def test_fused_and_int8_walks_refuse_other_families(family):
    """The fused-block and int8 walks cover the plain width-1.0
    MobileNetV2 SSD only, as in the JAX package
    (watsor_tpu/models/ssd_fused.py:117-121)."""
    from watsor_tpu_torch.models.ssd_fused import build_fused_detector
    from watsor_tpu_torch.models.ssd_int8 import build_int8_detector
    _, cfg = _configs(family, 'fused')
    detector = build_detector(cfg, device='cpu')
    with pytest.raises(ValueError, match='MobileNetV2 SSD only'):
        build_fused_detector(detector)
    with pytest.raises(ValueError, match='MobileNetV2 SSD only'):
        build_int8_detector(detector, np.zeros((1, SIZE, SIZE, 3), np.uint8))
