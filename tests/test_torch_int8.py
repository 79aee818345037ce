"""The port's int8 models against the JAX package's on the same seeded
inputs and the same weights (JAX PRNGKey(0) SSD-MobileNetV2 with 3
classes at 96x96, f32, batch 2): weight quantization, calibration, the
pack, the int8 walk in both pointwise modes and the int8 detector. The
kernel-level tests are in tests/test_torch_int8_matmul.py.

Each test states its bar. The int8 maps may differ by one quantum where
the two frameworks round an f32 product or sum differently at an exact
.5 (the bar of tests/test_int8_matmul.py)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import watsor_tpu.ops.int8_matmul as j_mm
from watsor_tpu.models import quantize as j_quant
from watsor_tpu.models import ssd_int8 as j_int8
from watsor_tpu.models.ssd import SSDConfig as JaxConfig
from watsor_tpu.models.ssd import build_detector as jax_build
from watsor_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from watsor_tpu_torch import workload
from watsor_tpu_torch.models import quantize as t_quant
from watsor_tpu_torch.models import ssd_int8 as t_int8
from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401
from test_torch_int8_matmul import _int8_close

SIZE = 96
BATCH = 2
RAW_REL_TOL = 5e-4
ABSMAX_RTOL = 1e-5
DETECT_TOL = 5e-3         # testing/golden.py:107, the golden score bar


@pytest.fixture(scope='module')
def rig():
    """(JAX detector, the port's detector on its weights, calibration
    frames, the JAX absmax)."""
    jax_det = jax_build(JaxConfig(num_classes=3, input_size=SIZE,
                                  dtype=jnp.float32, nms_mode='exact'))
    variables = jax.tree_util.tree_map(np.asarray, jax_det.params)
    port = build_detector(SSDConfig(num_classes=3, input_size=SIZE,
                                    dtype=torch.float32, nms_mode='exact'),
                          variables=variables, device='cpu')
    calib = np.random.default_rng(0).integers(0, 256, (4, SIZE, SIZE, 3),
                                              np.uint8)
    return jax_det, port, calib, j_int8.calibrate(jax_det, calib)


@pytest.fixture(scope='module')
def images():
    """uint8 frames and their [-1, 1] f32 model input, from both sides."""
    u8 = np.random.default_rng(3).integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                           np.uint8)
    want = jax_preprocess(jnp.asarray(u8), SIZE, SIZE, dtype=jnp.float32)
    return u8, want


@pytest.fixture(scope='module')
def packs(rig):
    """Both packs, built from the same (JAX) calibration."""
    jax_det, port, _, absmax = rig
    return (j_int8.build_pack(jax_det, absmax),
            t_int8.build_pack(port.variables, absmax, port.config,
                              device='cpu'))


@pytest.fixture
def jax_pallas_mode(monkeypatch):
    """The JAX walk with WATSOR_INT8_POINTWISE=pallas, its kernel in
    interpret mode, as tests/test_int8_matmul.py runs it on the CPU."""
    monkeypatch.setenv('WATSOR_INT8_POINTWISE', 'pallas')
    monkeypatch.setattr(j_mm, 'int8_matmul_requant', functools.partial(
        j_mm.int8_matmul_requant, interpret=True))


def test_quantize_params_matches_jax(rig):
    """int8 values and scales identical, on every conv kernel."""
    jax_det, port, _, _ = rig
    want = j_quant.quantize_params(jax_det.params)
    got = t_quant.quantize_params(port.variables)
    flat_want = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, j_quant.QuantizedLeaf))
    n = 0
    for path, leaf in flat_want:
        node = got
        for key in path:
            node = node[key.key]
        if isinstance(leaf, j_quant.QuantizedLeaf):
            assert isinstance(node, t_quant.QuantizedLeaf)
            np.testing.assert_array_equal(node.values,
                                          np.asarray(leaf.values))
            np.testing.assert_array_equal(node.scales,
                                          np.asarray(leaf.scales))
            n += 1
    assert n == 60 + 12                   # 60 units and 12 head convs


def test_quantization_error_reports_every_kernel(rig):
    """One entry per conv kernel, each at most half a quantum of the
    largest channel (1/254 of the kernel's absmax). The JAX function
    cannot be the reference here: it quantizes each kernel under the key
    'x', which its quantizer skips, and so raises on any tree."""
    jax_det, port, _, _ = rig
    with pytest.raises(AttributeError):
        j_quant.quantization_error(jax_det.params)
    got = t_quant.quantization_error(port.variables)
    assert len(got) == 72
    assert 'params/backbone/stem/Conv_0/kernel' in got
    assert all(0 < err <= 0.5 / 127 + 1e-7 for err in got.values())


def test_dequantize_params_matches_jax(rig):
    """values.astype(dtype) * scales.astype(dtype): every kernel identical
    in bf16; other leaves pass through."""
    jax_det, port, _, _ = rig
    want = j_quant.dequantize_params(j_quant.quantize_params(jax_det.params),
                                     jnp.bfloat16)
    got = t_quant.dequantize_params(t_quant.quantize_params(port.variables),
                                    torch.bfloat16)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for key in path:
            node = node[key.key]
        if path[-1].key == 'kernel':
            assert node.dtype == torch.bfloat16
            node = node.float().numpy()
        np.testing.assert_array_equal(node, np.asarray(leaf, np.float32))


def test_quantized_detector_raw_matches_jax(rig, images):
    """WATSOR_QUANTIZE=int8: raw outputs of the dequantized model within
    5e-4 relative to their magnitude."""
    jax_det, port, _, _ = rig
    jax_q = j_quant.build_quantized_detector(jax_det.config,
                                             params=jax_det.params)
    want = [np.asarray(a) for a in jax_q.raw_apply(
        j_quant.dequantize_params(jax_q.params, jnp.float32), images[1])]
    port_q = t_quant.build_quantized_detector(port.config, port.variables,
                                              device='cpu')
    with torch.inference_mode():
        got = [a.numpy() for a in port_q.raw_apply(
            torch.from_numpy(np.asarray(images[1])))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() / np.abs(w).max() < RAW_REL_TOL


def test_calibrate_matches_jax(rig):
    """absmax of every unit and block output within rtol 1e-5."""
    _, port, calib, want = rig
    got = t_int8.calibrate(port, calib)
    paths = t_int8._calibrated_paths(port.config)
    assert set(got) == set(paths)
    assert set(j_int8._unit_paths(JaxConfig())) <= set(got)
    for path in paths:
        assert got[path] == pytest.approx(want[path], rel=ABSMAX_RTOL), path


def test_build_pack_matches_jax(rig, packs):
    """Fed the JAX absmax: kernels, weight scales, biases, output scales
    and block scales identical."""
    jax_pack, pack = packs
    for path in t_int8._unit_paths(rig[1].config):
        key = '/'.join(path)
        want, got = jax_pack[key], pack[key]
        np.testing.assert_array_equal(got.kernel.numpy(),
                                      np.asarray(want.kernel))
        np.testing.assert_array_equal(got.wscale.numpy(),
                                      np.asarray(want.wscale))
        np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))
        assert got.out_scale == np.float32(want.out_scale), key
    assert pack['__scales__'] == {k: np.float32(v) for k, v in
                                  jax_pack['__scales__'].items()}


def _features_pair(packs, images, mode):
    jax_pack, pack = packs
    x = np.asarray(images[1])
    x_i8 = np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
    cfg = JaxConfig(num_classes=3, input_size=SIZE, dtype=jnp.float32)
    want = j_int8.quantized_features(jax_pack, jnp.asarray(x_i8),
                                     jnp.float32(1.0 / 127.0), cfg)
    got = t_int8.quantized_features(pack, torch.from_numpy(x_i8),
                                    np.float32(1.0 / 127.0), cfg, mode)
    return got, want


def _check_features(got, want):
    assert len(got) == len(want) == 6
    for (g, gs), (w, ws) in zip(got, want):
        assert g.dtype == torch.int8 and tuple(g.shape) == w.shape
        assert np.float32(gs) == np.float32(ws)
        _int8_close(g.numpy(), w)


@pytest.mark.parametrize('mode', ['conv', 'dot'])
def test_quantized_features_conv_mode_match_jax(packs, images, monkeypatch,
                                                mode):
    """WATSOR_INT8_POINTWISE=conv, and dot (XLA's dot_general in JAX, the
    conv walk in the port, whose sums are exact either way): each int8
    feature map within one quantum and >= 99.9% equal; scales
    identical."""
    monkeypatch.setenv('WATSOR_INT8_POINTWISE', mode)
    _check_features(*_features_pair(packs, images, mode))


def test_quantized_features_pallas_mode_match_jax(packs, images,
                                                   jax_pallas_mode):
    """WATSOR_INT8_POINTWISE=pallas (the JAX kernel interpreted): each int8
    feature map within one quantum and >= 99.9% equal; scales identical."""
    _check_features(*_features_pair(packs, images, 'pallas'))


def test_pointwise_calls_match_the_walk(packs, images, monkeypatch):
    """workload.int8_pointwise_calls lists the kernel calls of one forward,
    as the walk makes them (shapes, int8 or f32 output, relu6)."""
    calls = []
    real = t_int8.int8_matmul_requant

    def record(x, w, scale, bias, out_scale=None, relu6=True):
        calls.append((x.shape[0], x.shape[1], w.shape[1],
                      out_scale is not None, relu6))
        return real(x, w, scale, bias, out_scale, relu6)

    monkeypatch.setattr(t_int8, 'int8_matmul_requant', record)
    x_i8 = torch.zeros((BATCH, SIZE, SIZE, 3), dtype=torch.int8)
    t_int8.quantized_features(packs[1], x_i8, np.float32(1.0 / 127.0),
                              SSDConfig(num_classes=3, input_size=SIZE),
                              'pallas')
    assert calls == workload.int8_pointwise_calls(BATCH, SIZE)
    assert len(calls) == 38


@pytest.mark.parametrize('mode', ['conv', 'pallas'])
def test_int8_detect_batch_matches_jax(rig, mode, monkeypatch):
    """int8_full with nms: exact, one calibration for both: valid counts
    and labels equal; boxes and scores within 5e-3. The frames come at the
    model's size: the two resizes differ by about 1e-6, which the input's
    quantization can turn into a quantum, and the random-weight scores all
    sit within 1e-2 of 0.5, where that reorders detections."""
    jax_det, port, calib, absmax = rig
    monkeypatch.setenv('WATSOR_INT8_POINTWISE', mode)
    if mode == 'pallas':
        monkeypatch.setattr(j_mm, 'int8_matmul_requant', functools.partial(
            j_mm.int8_matmul_requant, interpret=True))
    # the JAX detector traces (and reads the mode) at its first call
    monkeypatch.setattr(j_int8, 'calibrate', lambda *args, **kw: absmax)
    jax_q = j_int8.build_int8_detector(jax_det, calib)
    port_q = t_int8.build_int8_detector(port, calib, absmax=absmax)
    frames = np.random.default_rng(4).integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                               np.uint8)
    want = [np.asarray(a) for a in jax_q.detect_batch(jax_q.params,
                                                      jnp.asarray(frames))]
    got = [a.numpy() for a in port_q.detect_batch(torch.from_numpy(frames))]
    assert (want[3] > 0).all()
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=DETECT_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DETECT_TOL)


def test_unknown_pointwise_mode_raises(monkeypatch):
    monkeypatch.setenv('WATSOR_INT8_POINTWISE', 'mxu')
    with pytest.raises(ValueError, match='WATSOR_INT8_POINTWISE'):
        t_int8._pointwise_mode()
