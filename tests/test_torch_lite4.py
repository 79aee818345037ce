"""``python -m watsor_tpu_torch.bench lite4`` (watsor_tpu_torch/measure/
lite4.py) on the CPU against the three scripts it ports:
scripts/profile_lite4.py, profile_lite4_sections.py and
profile_backbone_stages.py.

The sections it times are held against the JAX package's flax modules as
the scripts re-root them (``EfficientNetLite`` for the backbone,
``FPNOnly`` over ``ConvBN`` and ``BiFPN``, ``HeadsOnly`` over ``_Head``,
the stem ``ConvBN`` and ``StageRun`` over ``MBConvLite``) on one seeded
tree in f32: each within 5e-4 relative to its output's magnitude, the
converter-parity bar of BENCHMARKS.md "Parity proofs". The size is small:
EfficientDet-Lite0's backbone at 128x128 under a BiFPN of 16 channels, one
cell and one head repeat (tests/test_torch_families.py's), batch 2. The leg
itself runs at batch 1 with one step, the chains cut, on the zoo's Lite0
at 128x128, and its record's keys are held to the scripts', read with
``ast``. On the card ``chip_smoke.py`` phase 12 runs it on Lite4 at
640x640."""

import ast
import json
import os

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from watsor_tpu.models.efficientdet import BiFPN as JaxBiFPN
from watsor_tpu.models.efficientdet import EfficientDet as JaxEfficientDet
from watsor_tpu.models.efficientdet import _Head as JaxHead
from watsor_tpu.models.efficientdet import lite_config as jax_lite_config
from watsor_tpu.models.efficientnet_lite import (ConvBN, EfficientNetLite,
                                                 MBConvLite, lite_block_args)
from watsor_tpu_torch import bench, timing
from watsor_tpu_torch.measure import lite4
from watsor_tpu_torch.models import zoo
from watsor_tpu_torch.models.efficientdet import build_effdet, lite_config
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_REL_TOL = 5e-4
SMALL = dict(num_classes=3, fpn_channels=16, fpn_repeats=1, head_repeats=1,
             input_size=128)
BATCH = 2


def _redraw(node, rng, key=None):
    """The tree with BN scales, variances, biases and means drawn from
    ``rng`` (flax initializes them to constants, which would hide a
    swapped leaf); kernels kept."""
    if isinstance(node, dict):
        return {k: _redraw(v, rng, k) for k, v in sorted(node.items())}
    if key in ('scale', 'var'):
        return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
    if key in ('bias', 'mean'):
        return rng.normal(0.0, 0.1, node.shape).astype(np.float32)
    return node


@pytest.fixture(scope='module')
def pair():
    """(JAX config, seeded flax tree, the port's f32 detector on it)."""
    jax_cfg = jax_lite_config('lite0', dtype=jnp.float32, **SMALL)
    dummy = jnp.zeros((1, SMALL['input_size'], SMALL['input_size'], 3),
                      jnp.float32)
    init = jax.jit(JaxEfficientDet(jax_cfg).init)(jax.random.PRNGKey(0),
                                                  dummy)
    tree = _redraw(jax.tree_util.tree_map(np.asarray, init),
                   np.random.default_rng(0))
    port = build_effdet(lite_config('lite0', dtype=torch.float32, **SMALL),
                        variables=tree, device='cpu')
    return jax_cfg, tree, port


def _reroot(tree, key):
    return {col: tree[col][key] for col in tree}


def _pick(tree, keys):
    return {col: {k: tree[col][k] for k in keys} for col in tree}


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel < RAW_REL_TOL, (what, rel)


def _seeded(shape, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (BATCH,) + tuple(shape)).astype(np.float32)


def _jax_sections(cfg, tree):
    """The sections as profile_lite4_sections.py builds them: jitted
    ``apply`` of the backbone, ``FPNOnly`` and ``HeadsOnly`` on the tree
    re-rooted for each."""
    class FPNOnly(nn.Module):
        @nn.compact
        def __call__(self, c3, c4, c5):
            p6 = nn.max_pool(
                ConvBN(cfg.fpn_channels, (1, 1), act=False, dtype=cfg.dtype,
                       name='resample_p6')(c5, False),
                (3, 3), strides=(2, 2), padding='SAME')
            p7 = nn.max_pool(p6, (3, 3), strides=(2, 2), padding='SAME')
            feats = [c3, c4, c5, p6, p7]
            for r in range(cfg.fpn_repeats):
                feats = JaxBiFPN(cfg.fpn_channels, first_cell=(r == 0),
                                 weight_method=cfg.fpn_weight_method,
                                 dtype=cfg.dtype,
                                 name=f'bifpn{r}')(feats, False)
            return feats

    class HeadsOnly(nn.Module):
        @nn.compact
        def __call__(self, feats):
            num_cls = cfg.num_class_outputs
            cls_out = JaxHead(cfg.anchors_per_cell * num_cls,
                              cfg.head_repeats, cfg.fpn_channels,
                              dtype=cfg.dtype, name='cls_head')(feats, False)
            box_out = JaxHead(cfg.anchors_per_cell * 4, cfg.head_repeats,
                              cfg.fpn_channels, dtype=cfg.dtype,
                              name='box_head')(feats, False)
            B = feats[0].shape[0]
            boxes = jnp.concatenate(
                [b.reshape(B, -1, 4) for b in box_out], axis=1)
            logits = jnp.concatenate(
                [c.reshape(B, -1, num_cls) for c in cls_out], axis=1)
            return boxes.astype(jnp.float32), logits.astype(jnp.float32)

    backbone = EfficientNetLite(cfg.variant, dtype=cfg.dtype)
    fpn_keys = ['resample_p6'] + [f'bifpn{r}'
                                  for r in range(cfg.fpn_repeats)]
    bvars = _reroot(tree, 'backbone')
    fvars = _pick(tree, fpn_keys)
    hvars = _pick(tree, ('cls_head', 'box_head'))
    return (jax.jit(lambda x: backbone.apply(bvars, x, False)),
            jax.jit(lambda c3, c4, c5: FPNOnly().apply(fvars, c3, c4, c5)),
            jax.jit(lambda feats: HeadsOnly().apply(hvars, feats)))


def test_sections_match_the_jax_scripts_modules(pair):
    """The backbone's taps, the BiFPN's features and the heads' f32
    outputs of the port's sections against the re-rooted flax modules,
    each section on the same inputs (the JAX side's outputs of the one
    before)."""
    cfg, tree, port = pair
    backbone, fpn, heads = _jax_sections(cfg, tree)
    section = lite4.sections(port)
    x = _seeded((SMALL['input_size'],) * 2 + (3,), 1)
    taps = backbone(jnp.asarray(x))
    feats = fpn(*taps)
    want_heads = heads(feats)
    with torch.inference_mode():
        got_taps = section['backbone'](torch.from_numpy(x))
        got_feats = section['fpn']([torch.from_numpy(np.array(t))
                                    .permute(0, 3, 1, 2) for t in taps])
        got_heads = section['heads']([torch.from_numpy(np.array(f))
                                      .permute(0, 3, 1, 2) for f in feats])
    assert len(got_taps) == 3 and len(got_feats) == 5
    for i, (g, w) in enumerate(zip(got_taps, taps)):
        _close(_nhwc(g), np.asarray(w), 'tap {}'.format(i))
    for i, (g, w) in enumerate(zip(got_feats, feats)):
        _close(_nhwc(g), np.asarray(w), 'P{}'.format(i + 3))
    for g, w, what in zip(got_heads, want_heads, ('box_enc', 'logits')):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(w), what)


def test_stage_groups_match_the_jax_scripts_modules(pair):
    """Each group of profile_backbone_stages.py, the stem ``ConvBN`` and
    each stage's ``MBConvLite`` blocks on the re-rooted backbone tree,
    against the port's group on the same seeded input of the walk's
    shape; the groups' names, shapes and block counts are the walk's."""
    cfg, tree, port = pair
    bb = _reroot(tree, 'backbone')
    args = lite_block_args(cfg.variant)
    groups = lite4.stage_groups(port)
    stages = sorted({stage for *_, stage in args})
    assert [g[0] for g in groups] == ['stem'] + [f'stage{s}'
                                                 for s in stages]
    size = SMALL['input_size']
    assert groups[0][2] == (size, size, 3)
    assert groups[1][2] == (size // 2, size // 2, 32)
    for n, (name, run, in_shape, n_blocks, _) in enumerate(groups):
        x = _seeded(in_shape, 10 + n)
        if name == 'stem':
            want = jax.jit(lambda v, x: ConvBN(
                32, (3, 3), strides=2, dtype=cfg.dtype).apply(v, x, False))(
                    _reroot(bb, 'stem'), jnp.asarray(x))
            assert n_blocks == 0
        else:
            blocks = [(i,) + a[:4] for i, a in enumerate(args)
                      if a[4] == int(name[len('stage'):])]
            assert n_blocks == len(blocks)

            class StageRun(nn.Module):
                @nn.compact
                def __call__(self, x):
                    for i, expand, features, strides, kernel in blocks:
                        x = MBConvLite(features, kernel, strides, expand,
                                       dtype=cfg.dtype,
                                       name=f'block{i}')(x, False)
                    return x

            keys = [f'block{i}' for i, *_ in blocks]
            want = jax.jit(StageRun().apply)(_pick(bb, keys),
                                             jnp.asarray(x))
        with torch.inference_mode():
            got = run(torch.from_numpy(x).permute(0, 3, 1, 2))
        _close(_nhwc(got), np.asarray(want), name)


def test_section_chain_is_the_forward(pair):
    """heads(fpn(backbone(x))) over the model's own submodules equals
    ``raw_apply(x)`` bit for bit: the same modules in the same order."""
    _, _, port = pair
    section = lite4.sections(port)
    x = torch.from_numpy(_seeded((SMALL['input_size'],) * 2 + (3,), 2))
    with torch.inference_mode():
        got = section['heads'](section['fpn'](section['backbone'](x)))
        want = port.raw_apply(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the leg -----------------------------------------------------------------

@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """The leg on the zoo's Lite0 at 128x128, batch 1, one step, chains of
    1 and 2, from an empty working directory."""
    for knob in ('PROFILE_OUT', 'BENCH_BATCH', 'BENCH_STEPS', 'N_SHORT',
                 'N_LONG', 'WATSOR_FUSED_HEADS'):
        monkeypatch.delenv(knob, raising=False)
    for key, value in (('BENCH_BATCH', '1'), ('BENCH_STEPS', '1')):
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(lite4, 'VARIANT', 'lite0')
    monkeypatch.setitem(zoo.MODEL_REGISTRY, 'efficientdet_lite0',
                        lite_config('lite0', input_size=128))
    real = timing.chained_step_ms
    monkeypatch.setattr(timing, 'chained_step_ms', lambda run, **kw: real(
        run, n_short=1, n_long=2, reps=1, log=kw.get('log')))
    workdir = tmp_path / 'cwd'
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    return monkeypatch


def _run(argv, capsys):
    rc = bench.main(argv + ['--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def _tree(name):
    with open(os.path.join(ROOT, 'scripts', name + '.py')) as f:
        return ast.parse(f.read())


def _record_keys(name, variable):
    """The constant keys of ``variable[...] = ...`` and of the dict
    literal assigned to ``variable`` in scripts/<name>.py."""
    keys = set()
    for node in ast.walk(_tree(name)):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Subscript) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == variable and \
                isinstance(target.slice, ast.Constant):
            keys.add(target.slice.value)
        if isinstance(target, ast.Name) and target.id == variable and \
                isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
    return keys


def _row_names(name):
    """The constant first arguments of ``roofline_row(...)`` in
    scripts/<name>.py, and the format strings of the computed ones."""
    names = set()
    for node in ast.walk(_tree(name)):
        if isinstance(node, ast.Call) and \
                getattr(node.func, 'id', None) == 'roofline_row':
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value)
            elif isinstance(arg, ast.Call):        # '...'.format(...)
                names.add(arg.func.value.value)
    return names


def test_leg_prints_the_scripts_keys(tiny, capsys):
    """All eight parts: exit 0, one JSON line with the three scripts'
    record keys (``anchors`` from profile_lite4.py, ``device`` added), each
    part's row under its script's row name with the dispatch and chained
    times, positive; the stage rows of the walk; no file written."""
    rc, record = _run(['lite4'], capsys)
    assert rc == 0, record
    want = (_record_keys('profile_lite4', 'results') |
            _record_keys('profile_lite4_sections', 'results') |
            _record_keys('profile_backbone_stages', 'out')) | {'device'}
    assert set(record) == want
    assert record['variant'] == 'lite0' and record['batch'] == 1
    assert record['device'] == 'cpu' and record['anchors'] == 3069
    names = (_row_names('profile_lite4') |
             _row_names('profile_lite4_sections'))
    rows = {key: record[key]['model'] for key in
            ('full', 'forward', 'post', 'backbone', 'fpn', 'heads')}
    assert rows == {'full': 'full_step', 'forward': 'pre+forward',
                    'post': 'decode+nms', 'backbone': 'backbone',
                    'fpn': 'bifpn_x3', 'heads': 'heads'}
    assert set(rows.values()) - {'bifpn_x3'} | {'bifpn_x{}'} == names
    assert set(record['pre']) == {'ms_per_step', 'chained_ms_per_step'}
    stages = record['stages']
    assert [r['model'] for r in stages] == ['stem'] + [
        'stage{}'.format(s) for s in range(7)]
    assert stages[0]['in_shape'] == [128, 128, 3]
    assert stages[1]['in_shape'] == [64, 64, 32]
    assert [r['n_blocks'] for r in stages] == [0, 1, 2, 2, 3, 3, 4, 1]
    for row in list(record[k] for k in rows) + stages:
        assert row['ms_per_step'] > 0 and row['frames_per_s'] > 0
        # decode and the fused NMS do no matrix product FlopCounterMode counts
        assert row.get('gflops_per_frame', 0) > 0 or \
            row['model'] == 'decode+nms'
        assert row['hbm_mb_per_frame'] > 0
        assert 'FlopCounterMode' in row['flops_source']
    assert os.listdir('.') == []


def test_parts_choose_the_record_and_profile_out_appends(tiny, capsys,
                                                         tmp_path):
    """Operands choose the parts; PROFILE_OUT receives the record
    (appended, as profile_lite4_sections.py does)."""
    out = tmp_path / 'profile.jsonl'
    out.write_text('{"earlier": 1}\n')
    tiny.setenv('PROFILE_OUT', str(out))
    rc, record = _run(['lite4', 'pre', 'heads'], capsys)
    assert rc == 0, record
    assert set(record) == {'variant', 'batch', 'anchors', 'device', 'pre',
                           'heads'}
    lines = out.read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[1]) == record
    assert os.listdir('.') == []


def test_unknown_part_is_refused(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main(['lite4', 'neck', '--device', 'cpu'])
    assert exc.value.code == 2
    assert 'lite4 parts are' in capsys.readouterr().err


def test_without_a_card_the_leg_exits_1(monkeypatch, capsys):
    """No card and no ``--device``: bench.py's error record, exit 1, and
    nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(bench, 'run_command', None)
    assert bench.main(['lite4']) == 1
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record['metric'] == bench.METRICS['lite4']
    assert record['value'] == 0 and 'no CUDA device' in record['error']
