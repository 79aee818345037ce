"""RetinaNet-50 FPN (``ssd_resnet50_v1_fpn_1024``) on the port's SSD path
against the benchmark's plain reference (benchmark/configs/
ssd_resnet50_v1_fpn_1024.py), on the CPU: the raw outputs on seeded,
calibrated f32 weights at small sizes, the weight tree's layout, the
anchors bit for bit, the full size's anchors and FLOPs, the stored weights
deciding the geometry, the shared pyramid anchor generator against the
JAX package's EfficientDet anchors, and the forward's stage spans."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import cell, plain, spec
from watsor_tpu.models.efficientdet import effdet_anchors as jax_anchors
from watsor_tpu.models.efficientdet import lite_config as jax_lite_config
from watsor_tpu_torch.models.efficientdet import effdet_anchors, lite_config
from watsor_tpu_torch.models.ssd import (SSDConfig, anchors_for,
                                         build_detector, check_supported,
                                         ssd_normalizer)
from watsor_tpu_torch.models.weights import export_variables
from watsor_tpu_torch.models.zoo import (build_from_zoo, model_config,
                                         save_weights)
from watsor_tpu_torch.ops.anchors import MultiscaleAnchorSpec
from watsor_tpu_torch.runtime import spans

NAME = 'ssd_resnet50_v1_fpn_1024'
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, 'benchmark', 'configs')
STAGES = ('model.backbone', 'model.fpn', 'model.heads')
# one frame's operations by FlopCounterMode over the reference, GFLOP
STAGE_GFLOP = {'backbone': 161.161936896, 'fpn': 32.052871168,
               'heads': 263.279149056}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def reference(size=None):
    """(configuration, reference module), the configuration at ``size``."""
    with open(os.path.join(CONFIGS, NAME + '.json')) as f:
        cfg = json.load(f)
    if size is not None:
        cfg['input_size'] = size
    return cfg, spec.load_module(os.path.join(CONFIGS,
                                              cfg['reference'] + '.py'))


def port_config(size, **changes):
    return model_config(NAME)._replace(input_size=size, dtype=torch.float32,
                                       **changes)


def calibrated(size, seed, frames=4):
    """(cfg, ref, leaves, flat tree, tree, scenes) of ``seed`` at ``size``,
    the tree calibrated on the first ``frames`` scenes as a run draws
    them."""
    cfg, ref = reference(size)
    generator = torch.Generator().manual_seed(seed)
    leaves = plain.layout(ref.forward, cfg, size)
    flat_t, tree = plain.seeded_tree(leaves, generator, 'cpu')
    scenes = cell.scenes(6, size, generator, 'cpu')
    with torch.no_grad():
        plain.calibrate(ref.forward, tree, leaves, cfg,
                        scenes[:frames].float())
    return cfg, ref, leaves, flat_t, tree, scenes


def flat(tree, prefix=''):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flat(value, prefix + key + '/')
        else:
            yield prefix + key, tuple(np.shape(value))


@pytest.mark.parametrize('size', [128, 192])
def test_reference_matches_the_port_plain_path(size):
    """On the same seeded, calibrated weights, the port's f32 outputs lie
    within 4 times the reference's own f32 distance from its float64
    answer, box encodings and logits alike."""
    cfg, ref, leaves, flat_t, tree, scenes = calibrated(size, 2 ** 31 + 17)
    port_cfg = port_config(size)
    detector = build_detector(port_cfg,
                              variables=plain.nested_numpy(flat_t, leaves),
                              device='cpu')
    frames = scenes[4:].float()
    wide = plain.Weights({k: v.double() for k, v in tree.items()})
    with torch.no_grad():
        ours = ref.forward(plain.Weights(tree), frames, cfg)
        exact = ref.forward(wide, frames.double(), cfg)
        port = detector.raw_apply(ssd_normalizer(port_cfg)(frames))
    assert port[1].shape == (2, len(detector.anchors), 91)
    for mine, truth, theirs in zip(ours, exact, port):
        rounding = float((mine.double() - truth).abs().max())
        assert 0 < rounding < 1e-3
        assert float((theirs.double() - truth).abs().max()) <= 4 * rounding


def test_exported_tree_is_the_reference_layout():
    """The port's weight tree has the reference's leaves, path for path and
    shape for shape: one tower convolution shared by the levels, a
    BatchNorm a level."""
    cfg, ref = reference(128)
    leaves = plain.layout(ref.forward, cfg, 128)
    detector = build_detector(port_config(128), device='cpu')
    assert dict(flat(export_variables(detector.model))) == \
        {leaf.path: leaf.shape for leaf in leaves}
    paths = {leaf.path for leaf in leaves}
    assert 'params/cls_tower/conv3/kernel' in paths
    assert 'batch_stats/box_tower/bn3_l4/var' in paths
    assert 'params/backbone/conv5_block3/conv3/Conv_0/kernel' in paths


@pytest.mark.parametrize('size', [128, 192, 1024])
def test_anchors_are_the_reference_s_bit_for_bit(size):
    cfg, ref = reference(size)
    ours = anchors_for(port_config(size))
    assert ours.dtype == np.float32
    assert ours.tobytes() == ref.anchors(cfg).tobytes()


def test_full_size_anchors_and_flops():
    """At 1024x1024: 130,944 anchors (6 a cell over 21,824 positions), and
    456.49 GFLOP a frame, the heads more than half of it."""
    cfg, ref = reference()
    assert len(anchors_for(model_config(NAME))) == cfg['anchors'] == 130944
    flops = ref.stage_flops(cfg)
    assert {k: v / 1e9 for k, v in flops.items()} == \
        pytest.approx(STAGE_GFLOP, abs=1e-6)
    assert plain.forward_flops(ref.forward, cfg) == sum(flops.values())


def test_stored_weights_decide_the_geometry(tmp_path):
    """``build_from_zoo`` on a tree ``save_weights`` wrote takes the class
    count from the class predictor's bias, not from the registry, and
    adopts the tree."""
    stored = model_config(NAME)._replace(num_classes=3, dtype=torch.float32)
    variables = build_detector(stored, seed=3, device='cpu').variables
    save_weights(variables, str(tmp_path), NAME)
    rebuilt = build_from_zoo(NAME, str(tmp_path), device='cpu',
                             dtype=torch.float32)
    assert rebuilt.config == stored
    assert dict(flat(rebuilt.variables)) == dict(flat(variables))
    np.testing.assert_array_equal(
        rebuilt.variables['params']['cls_tower']['predict']['bias'],
        variables['params']['cls_tower']['predict']['bias'])


@pytest.mark.parametrize('variant', ['lite0', 'lite1', 'lite2', 'lite3',
                                     'lite4'])
def test_effdet_anchors_hold_on_the_shared_generator(variant):
    """EfficientDet's anchors, now from the shared pyramid generator, are
    the JAX package's byte for byte."""
    ours = effdet_anchors(lite_config(variant))
    theirs = np.asarray(jax_anchors(jax_lite_config(variant)))
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.tobytes() == theirs.tobytes()


def test_the_config_refuses_what_its_backbone_cannot_feed():
    pyramid = MultiscaleAnchorSpec()
    for bad in (SSDConfig(anchor_spec=pyramid),
                SSDConfig(backbone='resnet50_v1'),
                SSDConfig(backbone='resnet50_v1', lite=True,
                          anchor_spec=pyramid),
                SSDConfig(backbone='resnet50_v1',
                          anchor_spec=pyramid._replace(max_level=4))):
        with pytest.raises(ValueError):
            check_supported(bad)
    check_supported(model_config(NAME))


@pytest.fixture(scope='module')
def small():
    return build_detector(port_config(128, active_labels=(1, 3),
                                      nms_mode='fused_exact'),
                          seed=0, device='cpu')


def test_the_stage_spans_under_a_capture(small):
    """Under a CPU profiler capture the detect step records the three
    stage spans once each, in order, with their counts and no device
    stamp (no CUDA here)."""
    frames = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8)
    spans.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with spans.span('outer', batch=spans.NEXT) as outer:
            small.detect_batch(frames)
    finally:
        prof.stop()
    got = [r for r in spans.records() if r.name in STAGES]
    assert [r.name for r in got] == list(STAGES)
    assert [r.counts for r in got] == [
        {}, {'levels': 5}, {'levels': 5, 'anchors': len(small.anchors)}]
    assert len(small.anchors) == 2046
    for before, after in zip(got, got[1:]):
        assert before.end_ns <= after.start_ns
    assert all(r.device_ns is None and r.parent == outer.id and
               r.batch == outer.batch for r in got)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(STAGES) <= names


def test_no_capture_records_nothing(small):
    spans.clear()
    with torch.no_grad():
        small.raw_apply(torch.zeros(1, 128, 128, 3))
    assert spans.records() == []


def test_a_span_stamps_no_device_but_a_cuda_one():
    """A span whose ``device`` is the CPU, or none, records without
    events: ``device_ns`` None."""
    recorder = spans.Recorder()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        for device in (torch.device('cpu'), 'cpu', None):
            with recorder.span('s', device=device, n=1):
                pass
    finally:
        prof.stop()
    records = recorder.records()
    assert len(records) == 3
    assert all(r.device_ns is None and r.counts == {'n': 1}
               for r in records)


def test_the_application_and_the_int8_mode_take_the_model():
    """The application accepts the name, and ``WATSOR_QUANTIZE=int8``'s
    detector (any ``ssd_`` model) subtracts the channel means as the float
    one does: its f32 detections are the float model's on its own
    dequantized weights."""
    import types

    from watsor_tpu_torch.main import detector_spec_from_config
    from watsor_tpu_torch.models.quantize import (build_quantized_detector,
                                                  dequantize_params,
                                                  quantize_params)
    config = {'model': NAME, 'cameras': [
        {'porch': {'detect': [{'person': {'confidence': 50}}]}}]}
    assert detector_spec_from_config(
        config, types.SimpleNamespace(model=None))[:2] == (NAME, {1})
    cfg = port_config(128, nms_mode='fused_exact')
    variables = build_detector(cfg, seed=5, device='cpu').variables
    quantized = build_quantized_detector(cfg, variables, device='cpu')
    restored = dequantize_params(quantize_params(variables), torch.float32)
    plain_step = build_detector(cfg, variables=restored, device='cpu')
    frames = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 128, 128, 3), np.uint8))
    for ours, theirs in zip(quantized.detect_batch(frames),
                            plain_step.detect_batch(frames)):
        torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)
