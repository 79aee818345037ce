"""The port's sharded train step and its sharding rule
(watsor_tpu_torch/parallel/) against the JAX package's
(watsor_tpu/parallel/), on the CPU at small size: the SSD of
tests/test_fleet.py's TINY (96x96, width 0.35, extras of 32, 3 classes)
and EfficientDet-Lite0 with fpn_channels=16, fpn_repeats=1,
head_repeats=1 at 32x32.

- ``param_shardings`` splits exactly the leaves JAX's splits, at model 2
  and 4, on TINY, on the production head geometry (300x300, 90 classes)
  and on EfficientDet (nothing splits).
- The port's ``make_sharded_train_step`` against JAX's on the 8 virtual
  CPU devices of tests/conftest.py, at (data 4, model 2) and (data 8,
  model 1), from one tree carried across by the weight bridge, two AdamW
  steps in f64 (``jax.enable_x64``): tests/test_torch_train.py's rules,
  each step's loss within 1e-3 relative, and here the first step's
  metrics (taken from the same weights) within its 1e-5.
- The sharded step against the port's unsharded step on the global batch,
  one step in f64 with SGD at learning rate 1 (the update is the
  gradient): the loss within 1e-12 relative, each new BatchNorm statistic
  within 1e-10 of its leaf's largest magnitude, each gradient within 1e-9
  of its leaf's largest magnitude, a leaf whose gradient is zero in exact
  arithmetic (under 1e-9 of the tree's largest) held under 1e-9 of the
  tree's largest; after it every replica's parameters and statistics equal
  bit for bit, over meshes whose devices repeat (``['cpu:0', 'cpu'] * 2``:
  two replicas to torch).
- A batch whose halves differ (dark and bright images, the ground truth
  in the bright half only): shard-local moments or a shard-local positive
  count miss those bars, which the global step meets.
- The exported tree saves the ``.msgpack`` bytes of the unsharded run.

Every tree has its BatchNorm parameters and statistics and its biases
redrawn from a numpy seed, as tests/test_torch_train.py redraws them
(flax initializes them to constants, under which a BatchNorm mean is 0 in
exact arithmetic and rounding noise in f64).
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.models import train as jax_train
from watsor_tpu.models.efficientdet import EfficientDet as JaxEfficientDet
from watsor_tpu.models.efficientdet import lite_config as jax_lite_config
from watsor_tpu.models.ssd import SSD as JaxSSD
from watsor_tpu.models.ssd import SSDConfig as JaxSSDConfig
from watsor_tpu.parallel import fleet as jax_fleet
from watsor_tpu.parallel import mesh as jax_mesh
from watsor_tpu_torch.models import train
from watsor_tpu_torch.models.efficientdet import lite_config
from watsor_tpu_torch.models.ssd import SSDConfig
from watsor_tpu_torch.models.weights import (export_variables, init_weights,
                                             leaves)
from watsor_tpu_torch.models.zoo import save_weights
from watsor_tpu_torch.parallel import (fleet, make_mesh,
                                       make_sharded_train_step,
                                       param_shardings)
from watsor_tpu_torch.testing.prepare import generate_batch
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

TINY = dict(num_classes=3, input_size=96, width_multiplier=0.35,
            extra_features=(32, 32, 32, 32))
EFFDET = dict(num_classes=3, input_size=32, fpn_channels=16, fpn_repeats=1,
              head_repeats=1)
LOSS_RTOL = 1e-12
STATS_TOL = 1e-10
GRAD_TOL = 1e-9
METRIC_REL_TOL = 1e-5
ADAMW_LOSS_RTOL = 1e-3


def _config(family, dtype=torch.float64):
    if family == 'ssd':
        return SSDConfig(dtype=dtype, **TINY)
    return lite_config('lite0', dtype=dtype, **EFFDET)


def _redraw(node, rng, key=None):
    if isinstance(node, dict):
        return {k: _redraw(v, rng, k) for k, v in sorted(node.items())}
    if key in ('scale', 'var', 'WSM'):
        return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
    if key in ('bias', 'mean'):
        return rng.normal(0.0, 0.1, node.shape).astype(np.float32)
    return node


@pytest.fixture(scope='module')
def trees():
    """family -> the port's seeded flax-layout tree, constants redrawn."""
    return {family: _redraw(export_variables(init_weights(
        train._model_for(_config(family, torch.float32)),
        torch.Generator().manual_seed(0))), np.random.default_rng(0))
        for family in ('ssd', 'effdet')}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flat(value, prefix + (str(key),))
    else:
        yield '/'.join(prefix), np.asarray(tree, np.float64)


def _batch(family, n=4, seed=1):
    size = _config(family).input_size
    batch = generate_batch(n, (size, size), seed=seed)
    return dict(batch, gt_boxes=batch['gt_boxes'].astype(np.float64))


def _f64_model(family):
    return train._model_for(_config(family)).to(torch.float64)


def _sgd():
    return functools.partial(torch.optim.SGD, lr=1.0)


# ---- param_shardings against JAX's ----------------------------------------

def _jax_names(module):
    """PyTorch parameter name -> the flax leaf path of ``module``."""
    names = {}
    for path, name, leaf in leaves(module):
        path = '/'.join(('params',) + path)
        if isinstance(leaf, torch.nn.Conv2d):
            names[name + '.weight'] = path + '/kernel'
            if leaf.bias is not None:
                names[name + '.bias'] = path + '/bias'
        elif isinstance(leaf, torch.nn.BatchNorm2d):
            names[name + '.weight'] = path + '/scale'
            names[name + '.bias'] = path + '/bias'
        else:
            names[name] = path
    return names


@pytest.mark.parametrize('model_size', [2, 4])
@pytest.mark.parametrize('geometry', ['tiny', 'production', 'effdet'])
def test_param_shardings_split_the_leaves_jax_splits(geometry, model_size):
    if geometry == 'effdet':
        cfg = lite_config('lite0', dtype=torch.float32, **EFFDET)
        jax_module = JaxEfficientDet(jax_lite_config(
            'lite0', dtype=jnp.float32, **EFFDET))
    else:
        fields = TINY if geometry == 'tiny' else {}
        cfg = SSDConfig(dtype=torch.float32, **fields)
        jax_module = JaxSSD(JaxSSDConfig(dtype=jnp.float32, **fields))
    with torch.device('meta'):
        module = train._model_for(cfg)
    size = cfg.input_size
    shapes = jax.eval_shape(functools.partial(jax_module.init, train=True),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    want = {jax.tree_util.keystr(path, simple=True, separator='/'):
            jax_mesh.MODEL_AXIS in tuple(sharding.spec)
            for path, sharding in jax.tree_util.tree_leaves_with_path(
                jax_mesh.param_shardings(
                    jax_mesh.make_mesh(8, model_parallel=model_size),
                    shapes))}
    mesh = make_mesh(devices=['cpu'] * 8, model_parallel=model_size)
    got = param_shardings(mesh, module)
    names = _jax_names(module)
    assert sorted(names) == sorted(got)
    assert {names[k]: v is not None for k, v in got.items()} == \
        {k: v for k, v in want.items() if k.startswith('params/')}
    split = sorted(k for k, v in got.items() if v)
    if geometry == 'effdet':
        assert not split
    else:
        assert 'box_head0.weight' in split and split
    if geometry == 'production':
        # 3 x 91 = 273 output channels: replicated at any even model size
        assert 'cls_head0.weight' not in split
        assert ('cls_head1.weight' in split) == (model_size == 2)
    # off: every parameter replicated
    assert not any(param_shardings(mesh, module, False).values())


# ---- the sharded step against JAX's --------------------------------------

def _jax_adamw(tree, batch, model_size, steps):
    """JAX's make_sharded_train_step over make_mesh(8, model_parallel=
    model_size), from ``tree`` in f64 (its init_train_state replaced by
    the tree carried across): each step's metrics."""
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)

        def init_train_state(config, rng, tx):
            return jax_train.TrainState(variables, jax.jit(tx.init)(
                variables['params']), jnp.zeros((), jnp.int32))

        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jax_fleet, 'init_train_state', init_train_state)
            state, step, shard_batch = jax_fleet.make_sharded_train_step(
                jax_mesh.make_mesh(8, model_parallel=model_size),
                JaxSSDConfig(dtype=jnp.float64, **TINY))
        history = []
        for _ in range(steps):
            state, metrics = step(state, shard_batch(batch))
            history.append({k: float(v) for k, v in metrics.items()})
        return history


@pytest.mark.parametrize('data,model_size', [(4, 2), (8, 1)])
def test_sharded_adamw_steps_match_jax(trees, data, model_size):
    batch = _batch('ssd', n=8)
    want = _jax_adamw(trees['ssd'], batch, model_size, steps=2)
    mesh = make_mesh(devices=['cpu'] * 8, model_parallel=model_size)
    assert mesh.shape == {'data': data, 'model': model_size}
    state, step, shard_batch = make_sharded_train_step(
        mesh, _config('ssd'), init=trees['ssd'], model=_f64_model('ssd'))
    assert bool(state.slices) == (model_size > 1)
    sharded = shard_batch(batch)
    got = [{k: float(v) for k, v in step(state, sharded).items()}
           for _ in want]
    for key in ('loss', 'cls_loss', 'box_loss', 'num_positive'):
        assert abs(got[0][key] - want[0][key]) <= \
            METRIC_REL_TOL * abs(want[0][key]), (key, got[0], want[0])
    for g, w in zip(got, want):
        assert abs(g['loss'] - w['loss']) <= ADAMW_LOSS_RTOL * abs(w['loss'])
    assert got[-1]['loss'] < got[0]['loss']
    assert state.step == 2


# ---- the sharded step against the port's unsharded step -------------------

def _unsharded(family, tree, batch):
    state = train.init_train_state(_config(family), tree, _sgd(),
                                   model=_f64_model(family), device='cpu')
    metrics = train.make_train_step(_config(family))(state, batch)
    return float(metrics['loss']), dict(_flat(export_variables(
        state.model, np.float64)))


def _sharded(family, tree, batch, devices, model_size):
    mesh = make_mesh(devices=devices, model_parallel=model_size)
    state, step, shard_batch = make_sharded_train_step(
        mesh, _config(family), init=tree, optimizer=_sgd(),
        model=_f64_model(family))
    metrics = step(state, shard_batch(batch))
    return float(metrics['loss']), state


def _misses(family, tree, batch, loss, state):
    """The bars the sharded step misses against the unsharded one:
    [(bar, worst), ...]."""
    want_loss, want = _unsharded(family, tree, batch)
    got = dict(_flat(state.variables(np.float64)))
    old = dict(_flat(tree))
    assert sorted(got) == sorted(want)
    misses = []
    if abs(loss - want_loss) > LOSS_RTOL * abs(want_loss):
        misses.append(('loss', abs(loss - want_loss) / abs(want_loss)))
    grads = {k: (old[k] - want[k], old[k] - got[k]) for k in want
             if k.startswith('params/')}
    tree_max = max(np.abs(w).max() for w, _ in grads.values())
    for key, (w, g) in grads.items():
        scale = np.abs(w).max()
        if scale < GRAD_TOL * tree_max:
            if np.abs(g).max() >= GRAD_TOL * tree_max:
                misses.append((key, np.abs(g).max() / tree_max))
        elif np.abs(g - w).max() > GRAD_TOL * scale:
            misses.append((key, np.abs(g - w).max() / scale))
    for key in want:
        if key.startswith('batch_stats/'):
            err = np.abs(got[key] - want[key]).max() / np.abs(want[key]).max()
            if err > STATS_TOL:
                misses.append((key, err))
    return misses


def _replicas_equal(state):
    """Every replica's replicated parameters and statistics, and every
    kernel slice held on more than one device, equal bit for bit."""
    trees = [dict(_flat(tree)) for tree in
             state.replica_variables(np.float64).values()]
    split = {'params/{}/kernel'.format(name) for name in state.slices}
    for tree in trees[1:]:
        assert {k for k in tree if k.rpartition('/')[0] not in split} == \
            {k for k in trees[0] if k.rpartition('/')[0] not in split}
    return all(np.array_equal(t[k], trees[0][k])
               for t in trees[1:] for k in t if k in trees[0])


@pytest.mark.parametrize('family,devices,model_size', [
    ('ssd', ['cpu'] * 4, 2),
    ('ssd', ['cpu:0', 'cpu'] * 2, 2),
    ('ssd', ['cpu:0', 'cpu'] * 2, 1),
    ('effdet', ['cpu:0', 'cpu'], 1),
    ('effdet', ['cpu'] * 4, 2)])
def test_sharded_step_matches_the_unsharded_step(trees, family, devices,
                                                 model_size):
    batch = _batch(family)
    loss, state = _sharded(family, trees[family], batch, devices, model_size)
    assert bool(state.slices) == (family == 'ssd' and model_size > 1)
    assert len(state.replicas) == len(set(map(str, devices)))
    assert _misses(family, trees[family], batch, loss, state) == []
    assert _replicas_equal(state)


def _two_halves():
    """Dark images with no ground truth, then bright ones with theirs."""
    batch = _batch('ssd')
    images = batch['images'].copy()
    images[:2] = images[:2] // 4
    valid = batch['gt_valid'].copy()
    valid[:2] = False
    assert valid[2:].any()
    return dict(batch, images=images, gt_valid=valid)


def _shard_local_loss(terms):
    """Each shard's loss over its own positive count, averaged."""
    losses = [train.combine_losses(*t)[0] for t in terms]
    loss = sum(l.to(losses[0].device) for l in losses) / len(losses)
    return loss, {'loss': loss.detach()}


@pytest.mark.parametrize('fault', [None, 'local moments', 'local positives'])
def test_global_moments_and_positives_have_teeth(trees, monkeypatch, fault):
    """The global step meets the bars on halves that differ; shard-local
    BatchNorm moments or a shard-local positive count miss them."""
    if fault == 'local moments':
        monkeypatch.setattr(fleet, 'exchanging_moments',
                            lambda exchange, shard: contextlib.nullcontext())
    elif fault == 'local positives':
        monkeypatch.setattr(fleet, '_global_loss', _shard_local_loss)
    batch = _two_halves()
    loss, state = _sharded('ssd', trees['ssd'], batch, ['cpu'] * 4, 2)
    misses = _misses('ssd', trees['ssd'], batch, loss, state)
    if fault is None:
        assert misses == []
    else:
        assert ('loss' in dict(misses) and
                any(k.startswith('params/') for k, _ in misses)), misses


def test_exported_tree_saves_the_unsharded_bytes(trees, tmp_path):
    """The gathered tree of a fresh (2, 2) state, and of a (1, 1) mesh after
    two AdamW steps, saves the bytes of the unsharded state's."""
    cfg = _config('ssd', torch.float32)
    batch = _batch('ssd')
    mesh = make_mesh(devices=['cpu:0', 'cpu'] * 2, model_parallel=2)
    state, _, _ = make_sharded_train_step(mesh, cfg, init=trees['ssd'])
    single = train.init_train_state(cfg, trees['ssd'], device='cpu')

    def saved(variables, name):
        with open(save_weights(variables, str(tmp_path), name), 'rb') as f:
            return f.read()

    assert saved(state.variables(), 'sharded') == \
        saved(single.variables(), 'single')
    state, step, shard_batch = make_sharded_train_step(
        make_mesh(devices=['cpu']), cfg, init=trees['ssd'])
    unsharded = train.make_train_step(cfg)
    for _ in range(2):
        step(state, shard_batch(batch))
        unsharded(single, batch)
    assert saved(state.variables(), 'sharded') == \
        saved(single.variables(), 'single')
