"""The plain reference against the port's plain path at a small size, on
weights drawn from a seed: the tree's layout leaf for leaf, the anchors,
the raw outputs (f32 on the CPU), and the yardstick's copies against the
program's originals."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.lib import plain, spec, work
from benchmark.tests.cpu import REPO


def reference(name):
    path = os.path.join(REPO, 'benchmark', 'configs', name)
    with open(path + '.json') as f:
        cfg = json.load(f)
    return cfg, spec.load_module(os.path.join(
        os.path.dirname(path), cfg['reference'] + '.py'))


def flat(tree, prefix=''):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flat(value, prefix + key + '/')
        else:
            yield prefix + key, tuple(np.shape(value))


CASES = [('efficientdet_lite4', 128), ('efficientdet_lite4', 192)]


def calibrated(cfg, ref, size, seed, frames=4):
    """(leaves, flat tree, tree, scenes) of ``seed`` at ``size``, the tree
    calibrated on the first ``frames`` scenes, as a run draws them."""
    from benchmark.lib import cell
    cfg['input_size'] = size
    generator = torch.Generator().manual_seed(seed)
    leaves = plain.layout(ref.forward, cfg, size)
    flat_t, tree = plain.seeded_tree(leaves, generator, 'cpu')
    scenes = cell.scenes(6, size, generator, 'cpu')
    with torch.no_grad():
        plain.calibrate(ref.forward, tree, leaves, cfg,
                        scenes[:frames].float())
    return leaves, flat_t, tree, scenes


@pytest.mark.parametrize('name,size', CASES)
def test_reference_matches_the_port_plain_path(name, size):
    from watsor_tpu_torch.models.efficientdet import (build_effdet,
                                                      normalize_effdet)
    from watsor_tpu_torch.models.zoo import model_config

    cfg, ref = reference(name)
    leaves, flat_t, tree, scenes = calibrated(cfg, ref, size, 2 ** 31 + 17)
    port_cfg = model_config(name)._replace(input_size=size,
                                           dtype=torch.float32)
    detector = build_effdet(port_cfg,
                            variables=plain.nested_numpy(flat_t, leaves),
                            device='cpu')
    from watsor_tpu_torch.models.weights import export_variables
    assert dict(flat(export_variables(detector.model))) == \
        {leaf.path: leaf.shape for leaf in leaves}
    np.testing.assert_array_equal(ref.anchors(cfg), detector.anchors)

    frames = scenes[4:].float()
    wide = plain.Weights({k: v.double() for k, v in tree.items()})
    with torch.no_grad():
        box, logits = ref.forward(plain.Weights(tree), frames, cfg)
        exact = ref.forward(wide, frames.double(), cfg)
        port = detector.raw_apply(normalize_effdet(frames, port_cfg))
    # f32 on both sides, the sums in another order: the port lies as near
    # the float64 answer as the reference's own f32 rounding does
    for ours, truth, theirs in zip((box, logits), exact, port):
        rounding = float((ours.double() - truth).abs().max())
        assert 0 < rounding < 1e-3
        assert float((theirs.double() - truth).abs().max()) <= 4 * rounding


def test_calibration_normalizes_every_batch_norm(monkeypatch):
    """After ``calibrate`` every BatchNorm reads, over the calibration
    frames, its own input's mean and variance: its output's mean is its
    bias, and its spread its scale, channel by channel, but where the
    input's variance lies under the floor's share of its mean square
    (there the spread is less); the class logits centre on 0."""
    cfg, ref = reference('efficientdet_lite4')
    leaves, _, tree, scenes = calibrated(cfg, ref, 128, 2 ** 31 + 5)
    seen = []
    batch_norm = plain.batch_norm

    def spy(w, path, x):
        y = batch_norm(w, path, x)
        seen.append((path, x, y))
        return y
    monkeypatch.setattr(ref, 'batch_norm', spy)
    monkeypatch.setattr(plain, 'batch_norm', spy)
    with torch.no_grad():
        _, logits = ref.forward(plain.Weights(tree), scenes[:4].float(), cfg)
    assert len(seen) == sum(leaf.kind == 'mean' for leaf in leaves)
    floored = 0
    for path, x, y in seen:
        bias = tree['params/{}/bias'.format(path)]
        scale = tree['params/{}/scale'.format(path)].abs()
        torch.testing.assert_close(y.mean((0, 2, 3)), bias, atol=1e-3,
                                   rtol=0)
        spread = y.std((0, 2, 3), unbiased=False)
        var = x.var((0, 2, 3), unbiased=False)
        low = var < plain.SPREAD_FLOOR * x.square().mean((0, 2, 3))
        # a channel whose input varies by less than BN_EPS keeps it small
        live = ~low & (var > 100 * plain.BN_EPS)
        torch.testing.assert_close(spread[live], scale[live], rtol=1e-2,
                                   atol=0)
        assert bool((spread[low] <= scale[low] * 1.01).all()), path
        floored += int(low.sum())
    assert floored > 0
    assert float(logits.mean((0, 1)).abs().max()) < 1e-3


def test_another_frame_moves_the_answer_more_than_bf16_rounding():
    """What the faults that hand a frame another frame's answer rest on:
    at a small size the logits of another scene differ from a scene's by
    several times what rounding every convolution to bf16 moves them."""
    cfg, ref = reference('efficientdet_lite4')
    _, _, tree, scenes = calibrated(cfg, ref, 128, 2 ** 31 + 9)

    def bf16(t):
        return t.to(torch.bfloat16).float()
    frames = scenes[4:].float()
    with torch.no_grad():
        _, exact = ref.forward(plain.Weights(tree), frames, cfg)
        _, rounded = ref.forward(plain.Weights(tree, quantize=bf16), frames,
                                 cfg)
    rounding = float((rounded - exact).abs().median())
    other = float((exact[0] - exact[1]).abs().median())
    assert other > 4 * rounding, (other, rounding)


def test_full_size_layouts_and_flops():
    for name, anchors, gflop in (('efficientdet_lite4', 76725, 40.34),):
        cfg, ref = reference(name)
        assert len(ref.anchors(cfg)) == cfg['anchors'] == anchors
        assert plain.forward_flops(ref.forward, cfg) / 1e9 == \
            pytest.approx(gflop, abs=0.005)


def test_yardstick_copies_match_the_program():
    from watsor_tpu_torch import workload
    assert work.fixed_point_work(64, 2, 128) == \
        workload.fixed_point_work(64, 2, 128)
    assert work.PEAK_OPS_S == workload.PEAK_OPS_S
    assert work.HBM_BYTES_S == workload.HBM_BYTES_S


def test_seeded_tree_is_the_seed_s_and_only_the_seed_s():
    cfg, ref = reference('efficientdet_lite4')
    leaves = plain.layout(ref.forward, cfg, 128)
    big = 2 ** 31 + 99

    def draw(seed):
        return plain.seeded_tree(leaves, torch.Generator().manual_seed(seed),
                                 'cpu')[0]
    assert torch.equal(draw(big), draw(big))
    assert not torch.equal(draw(big), draw(big + 1))
    var = [leaf for leaf in leaves if leaf.kind == 'var']
    _, tree = plain.seeded_tree(leaves, torch.Generator().manual_seed(big),
                                'cpu')
    assert min(float(tree[leaf.path].min()) for leaf in var) > 0.3


def test_fp8_control_rounds_to_e4m3():
    t = torch.linspace(-3, 3, 1001)
    q = plain.fp8_e4m3(t)
    assert float((q - t).abs().max()) > 1e-3
    assert float(((q - t).abs() / t.abs().clamp_min(1e-3)).max()) <= 0.07
