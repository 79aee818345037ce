"""The port's training path (watsor_tpu_torch/models/train.py) against the
JAX package's (watsor_tpu/models/train.py) at small size, on one seeded
tree a family: the SSD's the JAX package's PRNGKey(0) init carried across
by the weight bridge, EfficientDet's the port's flax-default
initialization from torch seed 0 exported in the flax layout (every
shape held against the JAX module's ``eval_shape`` init; a compiled JAX
init costs an XLA compile of its own), with every
BatchNorm's parameters and statistics, every bias and the fast-attention
weights redrawn from a numpy seed (flax initializes them to constants,
which would hide a swapped leaf). Families: the SSD of tests/test_train.py
(MobileNetV2 width 0.35, extras of 32, 128x128, 3 classes) and
EfficientDet-Lite0 with fpn_channels=16, fpn_repeats=1, head_repeats=1.

The SGD step (learning rate 1, so the update is the gradient), the AdamW
steps and precise BN are compared in f64 on both sides
(``jax.enable_x64``): the f32 gradients of these train-mode BatchNorm
networks are ill-conditioned (the fast variance E[x^2] - E[x]^2 over
nearly constant channels, BatchNorm over a handful of values at the 1x1
extras), so that JAX's own f32 gradients lie further from its f64 ones
than any bar below, and the port's f32 ones too. The ground-truth boxes
are f64 there too, and with them the box targets on both sides. A
BatchNorm bias whose output reaches the loss only through train-mode
BatchNorms has a zero gradient in exact arithmetic; such a leaf (its JAX
f64 gradient under 1e-9 of the tree's largest) is held to the same 1e-9
on the port's side. The SSD runs
at 96x96, EfficientDet at 32x32, each on 4 images (XLA's f64 depthwise
convolutions are slow on the CPU); smaller, the SSD's extras normalize
over so few values that even f64 amplifies the f32 rounding of the
normalized input (the JAX step normalizes in f32) past the bars.

The port's step at the models' own dtypes: in f32 the metrics within
1e-5 relative and the new running statistics within 1e-5 of each leaf's
largest magnitude of JAX's f64 step (JAX's own f32 step on the CPU lies
further from its f64 step than that), in bf16 the loss and the
statistics within the bf16 bar of 5e-2 of JAX's bf16 step.

Every JAX computation here is compiled once (the steps, the optimizer
update, precise BN), none run op by op: each eager JAX operation compiles
a program of its own, which cost tens of seconds over a few hundred
leaves.

Bars: loss and metrics 1e-5 relative; gradients 1e-4 of each leaf's
largest magnitude; the new running statistics 1e-5 and precise BN 1e-4,
relative to each leaf's largest magnitude too (``_check_stats``); AdamW
1e-6 against optax over 5 steps and the losses of 3 AdamW train steps
1e-3 relative; box encoding and the losses 1e-6; matching exact.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.models import train as jax_train
from watsor_tpu.models.efficientdet import EfficientDet as JaxEfficientDet
from watsor_tpu.models.efficientdet import lite_config as jax_lite_config
from watsor_tpu.models.ssd import SSD as JaxSSD
from watsor_tpu.models.ssd import SSDConfig as JaxSSDConfig
from watsor_tpu.ops.boxes import encode_boxes as jax_encode_boxes
from watsor_tpu_torch.models import efficientdet, train
from watsor_tpu_torch.models.efficientdet import build_effdet, lite_config
from watsor_tpu_torch.models.ssd import SSDConfig
from watsor_tpu_torch.models.weights import export_variables, init_weights
from watsor_tpu_torch.ops.boxes import decode_boxes, encode_boxes
from watsor_tpu_torch.testing.prepare import generate_batch
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401


# family -> (input size, batch)
SHAPES = {'ssd': (96, 4), 'effdet': (32, 4)}
SSD_SMALL = dict(num_classes=3, input_size=SHAPES['ssd'][0],
                 width_multiplier=0.35, extra_features=(32, 32, 32, 32))
EFFDET_SMALL = dict(num_classes=3, input_size=SHAPES['effdet'][0],
                    fpn_channels=16, fpn_repeats=1, head_repeats=1)
METRIC_REL_TOL = 1e-5
GRAD_TOL = 1e-4
STATS_REL_TOL = 1e-5
BF16_REL_TOL = 5e-2
ZERO_GRAD = 1e-9


def _configs(family, jax_dtype, dtype):
    if family == 'ssd':
        return (JaxSSDConfig(dtype=jax_dtype, **SSD_SMALL),
                SSDConfig(dtype=dtype, **SSD_SMALL))
    return (jax_lite_config('lite0', dtype=jax_dtype, **EFFDET_SMALL),
            lite_config('lite0', dtype=dtype, **EFFDET_SMALL))


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


@pytest.fixture(scope='module')
def trees():
    """family -> a train-mode flax tree, constants redrawn: the SSD's the
    JAX PRNGKey(0) init, EfficientDet's the port's seeded init, each leaf
    of the shape JAX's init gives (``eval_shape``, which compiles
    nothing)."""
    out = {}
    for family in ('ssd', 'effdet'):
        jax_cfg, cfg = _configs(family, jnp.float32, torch.float32)
        init = functools.partial(
            (JaxSSD if family == 'ssd' else JaxEfficientDet)(jax_cfg).init,
            train=True)
        size = SHAPES[family][0]
        args = jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))
        if family == 'ssd':
            tree = jax.tree_util.tree_map(np.asarray, jax.jit(init)(*args))
        else:
            tree = export_variables(init_weights(
                train._model_for(cfg), torch.Generator().manual_seed(0)))
            assert _shapes(tree) == _shapes(jax.eval_shape(init, *args))
        out[family] = _redraw(tree, np.random.default_rng(0))
    return out


def _shapes(tree):
    return {jax.tree_util.keystr(path): tuple(leaf.shape) for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(family, seed=1, boxes=np.float64):
    """Painted images; the boxes in f64 for the f64 steps, so that both
    sides take their box targets in f64."""
    size, n = SHAPES[family]
    batch = generate_batch(n, (size, size), seed=seed)
    return dict(batch, gt_boxes=batch['gt_boxes'].astype(boxes))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flat(value, prefix + (key,))
    else:
        yield '/'.join(prefix), np.asarray(tree, np.float64)


def _model_tree(model):
    """The flat variables of ``model`` at f64, reading an f64 model
    exactly."""
    return dict(_flat(export_variables(model, np.float64)))


_JAX_STEPS = {}


def _jax_step(family, dtype, stats_only=False):
    """JAX's train step of ``family`` at the activation ``dtype`` with SGD
    at learning rate 1, jitted once and shared across tests: (new
    variables, metrics). ``stats_only``: the new variables hold the
    running statistics alone, and XLA prunes the backward and the update,
    which nothing then reads."""
    key = family, dtype, stats_only
    if key not in _JAX_STEPS:
        jax_cfg, _ = _configs(family, dtype, torch.float32)
        step = jax_train.make_train_step(jax_cfg, optax.sgd(1.0))
        if stats_only:
            def step(state, batch, whole=step):
                new, metrics = whole(state, batch)
                return {'batch_stats': new.params['batch_stats']}, metrics
        else:
            def step(state, batch, whole=step):
                new, metrics = whole(state, batch)
                return new.params, metrics
        _JAX_STEPS[key] = jax.jit(step)
    return _JAX_STEPS[key]


def _apply_update(tx, variables, stepped, opt_state):
    """``tx`` applied to the gradients of an SGD step at learning rate 1
    (old - new parameters), as ``make_train_step`` applies it inside its
    step; the statistics are the step's."""
    params = variables['params']
    grads = jax.tree_util.tree_map(jnp.subtract, params, stepped['params'])
    updates, opt_state = tx.update(grads, opt_state, params)
    return {'params': optax.apply_updates(params, updates),
            'batch_stats': stepped['batch_stats']}, opt_state


def _jax_run(family, tree, batch, tx=None, steps=1, dtype=jnp.float64,
             stats_only=False):
    """(new flat variables, [metrics of each step]) of ``steps`` JAX train
    steps at the activation ``dtype``: f64 parameters under
    ``jax.enable_x64`` for f64, f32 parameters otherwise. ``tx``: None for
    SGD at learning rate 1, else an optax transformation fed each step's
    gradients (one jitted update). ``stats_only``: one step's metrics and
    new running statistics alone (``_jax_step``)."""
    x64 = dtype == jnp.float64
    with jax.enable_x64(x64):
        step = _jax_step(family, dtype, stats_only)
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(
                a, np.float64 if x64 else np.float32)), tree)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        if tx is not None:
            update = jax.jit(functools.partial(_apply_update, tx))
            opt_state = jax.jit(tx.init)(variables['params'])
        history = []
        for _ in range(steps):
            stepped, metrics = step(jax_train.TrainState(
                variables, optax.sgd(1.0).init(variables['params']),
                jnp.zeros((), jnp.int32)), batch)
            if tx is None:
                variables = stepped
            else:
                variables, opt_state = update(variables, stepped, opt_state)
            history.append({k: float(v) for k, v in metrics.items()})
        return dict(_flat(jax.tree_util.tree_map(np.asarray,
                                                 variables))), history


def _port_state(family, tree, dtype, optimizer):
    _, cfg = _configs(family, jnp.float32, dtype)
    model = train._model_for(cfg).to(torch.float64) \
        if dtype == torch.float64 else None
    return cfg, train.init_train_state(cfg, tree, optimizer, model=model,
                                       device='cpu')


def _check_metrics(got, want):
    for key in ('loss', 'cls_loss', 'box_loss', 'num_positive'):
        assert abs(float(got[key]) - want[key]) <= \
            METRIC_REL_TOL * abs(want[key]), (key, float(got[key]), want[key])


@pytest.mark.parametrize('family', ['ssd', 'effdet'])
def test_sgd_step_matches_jax(family, trees):
    """One step with SGD at learning rate 1 on both sides: the metrics, the
    update (the gradient) and the new BatchNorm running statistics. The
    EfficientDet case trains its negatives toward the all-zero row of a
    head without a background column (``F.one_hot`` of label - 1 would
    raise at label 0)."""
    tree, batch = trees[family], _batch(family)
    want, (want_metrics,) = _jax_run(family, tree, batch)
    cfg, state = _port_state(family, tree, torch.float64,
                             functools.partial(torch.optim.SGD, lr=1.0))
    metrics = train.make_train_step(cfg)(state, batch)
    _check_metrics(metrics, want_metrics)
    assert state.step == 1
    got = _model_tree(state.model)
    assert sorted(got) == sorted(want)
    old = dict(_flat(tree))
    grads = {k: (old[k] - want[k], old[k] - got[k]) for k in want
             if k.startswith('params/')}
    tree_max = max(np.abs(w).max() for w, _ in grads.values())
    for key, (w, g) in grads.items():
        scale = np.abs(w).max()
        if scale < ZERO_GRAD * tree_max:
            assert np.abs(g).max() < ZERO_GRAD * tree_max, key
        else:
            assert np.abs(g - w).max() <= GRAD_TOL * scale, \
                (key, np.abs(g - w).max() / scale)
    for key in want:
        if key.startswith('batch_stats/'):
            _check_stats(got[key], want[key], STATS_REL_TOL, key)


def _check_stats(got, want, tol, key):
    """Running statistics within ``tol`` relative to their leaf's largest
    magnitude: a mean near 0 has no relative error of its own, and the JAX
    step's f32 normalization on the CPU rounds a white pixel to 1 + 2^-23
    (a fused multiply-add) where the port's gives 1."""
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        (key, np.abs(got - want).max() / np.abs(want).max())


def test_no_ground_truth_clamps_num_positive(trees):
    """A batch without a valid ground truth: num_positive reports the
    clamp at 1, the box loss is 0, and the loss equals JAX's."""
    batch = _batch('ssd')
    empty = dict(batch, gt_valid=np.zeros_like(batch['gt_valid']))
    _, (want,) = _jax_run('ssd', trees['ssd'], empty)
    cfg, state = _port_state('ssd', trees['ssd'], torch.float64,
                             functools.partial(torch.optim.SGD, lr=1.0))
    metrics = train.make_train_step(cfg)(state, empty)
    assert float(metrics['num_positive']) == want['num_positive'] == 1.0
    assert float(metrics['box_loss']) == 0.0
    _check_metrics(metrics, want)


def test_adamw_train_steps_match_jax(trees):
    """Three train steps with make_optimizer() on both sides: each step's
    loss within 1e-3 relative of JAX's, and the loss falls. (Adam moves
    every element by about the learning rate whatever its gradient's size,
    so elements whose gradient is near its rounding can move apart; at
    make_optimizer's rate they stay far inside the bar.)"""
    batch = _batch('ssd')
    _, history = _jax_run('ssd', trees['ssd'], batch,
                          tx=jax_train.make_optimizer(), steps=3)
    cfg, state = _port_state('ssd', trees['ssd'], torch.float64,
                             train.make_optimizer())
    step = train.make_train_step(cfg)
    for want in history:
        got = float(step(state, batch)['loss'])
        assert abs(got - want['loss']) <= 1e-3 * abs(want['loss']), \
            (got, want['loss'])
    assert history[-1]['loss'] < history[0]['loss']


def test_make_optimizer_is_optax_adamw():
    """5 steps of seeded gradients through make_optimizer and through
    optax.adamw as the JAX package configures it (1e-6)."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3, 3, 3), (7,), (2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tx = jax_train.make_optimizer(learning_rate=1e-2, weight_decay=1e-2)
    want = [jnp.asarray(p) for p in params]
    opt_state = tx.init(want)
    tensors = [torch.tensor(p, requires_grad=True) for p in params]
    optimizer = train.make_optimizer(learning_rate=1e-2,
                                     weight_decay=1e-2)(tensors)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, want)
        want = optax.apply_updates(want, updates)
        for t, x in zip(tensors, g):
            t.grad = torch.from_numpy(x)
        optimizer.step()
    for t, w in zip(tensors, want):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_calibrate_batch_stats_matches_jax(trees):
    """Precise BN over 2 batches against JAX's (1e-4 relative), in f64 on
    both sides as the step (the JAX version recovers each moment from two
    momentum updates, exact only where the arithmetic is); a tree without
    statistics passes through."""
    tree = trees['ssd']
    batches = [_batch('ssd', seed)['images'] for seed in (1, 2)]
    with jax.enable_x64(True):
        jax_cfg, _ = _configs('ssd', jnp.float64, torch.float32)
        want = jax.jit(functools.partial(
            jax_train.calibrate_batch_stats, jax_cfg))(
            jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a, np.float64)), tree),
            [jnp.asarray(b) for b in batches])
        want = dict(_flat(jax.tree_util.tree_map(np.asarray, want)))
    _, cfg = _configs('ssd', jnp.float32, torch.float64)
    model = train._model_for(cfg).to(torch.float64)
    got = train.calibrate_batch_stats(cfg, tree, batches, model=model,
                                      device='cpu')
    got_stats = _model_tree(model)
    for key in want:
        if key.startswith('batch_stats/'):
            _check_stats(got_stats[key], want[key], 1e-4, key)
        else:
            np.testing.assert_array_equal(dict(_flat(got))[key], want[key])
    bare = {'params': tree['params']}
    assert train.calibrate_batch_stats(cfg, bare, batches,
                                       device='cpu') is bare


def _port_step_at(dtype, trees):
    """One SGD step of the port's SSD at the activation ``dtype``, f32
    parameters and boxes: (metrics, state)."""
    cfg, state = _port_state('ssd', trees['ssd'], dtype,
                             functools.partial(torch.optim.SGD, lr=1.0))
    metrics = train.make_train_step(cfg)(state,
                                         _batch('ssd', boxes=np.float32))
    return metrics, state


def _check_new_stats(state, want, tol):
    got = dict(_flat(export_variables(state.model)))
    for key in want:
        if key.startswith('batch_stats/'):
            _check_stats(got[key], want[key], tol, key)


def test_f32_step_matches_jax(trees):
    """The f32 step (f32 activations, BatchNorm moments and box targets)
    on the same weights and batch as JAX's step: the metrics within 1e-5
    relative and the new running statistics within 1e-5 of each leaf's
    largest magnitude. The reference is JAX's f64 step: JAX's own f32 step
    on the CPU lies further than these bars from it (its f32 moments and
    sums round differently), where the port's f32 step stays inside them.
    The f32 gradients are ill-conditioned; they are held in f64
    (``test_sgd_step_matches_jax``)."""
    want, (want_metrics,) = _jax_run('ssd', trees['ssd'], _batch('ssd'))
    metrics, state = _port_step_at(torch.float32, trees)
    assert all(m.dtype == torch.float32 for m in metrics.values())
    _check_metrics(metrics, want_metrics)
    _check_new_stats(state, want, STATS_REL_TOL)


def test_bf16_step_takes_its_losses_in_f32(trees):
    """A bf16 model trains with f32 parameters, f32 running statistics and
    f32 losses, and its step agrees with JAX's bf16 step on the same
    weights and batch within the bf16 bar (5e-2): the loss relative, the
    new running statistics of each leaf's largest magnitude."""
    want, (want_metrics,) = _jax_run(
        'ssd', trees['ssd'], _batch('ssd', boxes=np.float32),
        dtype=jnp.bfloat16, stats_only=True)
    metrics, state = _port_step_at(torch.bfloat16, trees)
    assert all(m.dtype == torch.float32 for m in metrics.values())
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for b in state.model.buffers()
               if b.is_floating_point())
    loss = float(metrics['loss'])
    assert abs(loss - want_metrics['loss']) <= \
        BF16_REL_TOL * abs(want_metrics['loss']), (loss, want_metrics)
    _check_new_stats(state, want, BF16_REL_TOL)


def test_training_after_an_inference_mode_detect_step(trees):
    """The serving step caches EfficientDet's upsample indices (and the
    resize matrices) under torch.inference_mode; a train step in the same
    process must be able to save them for backward."""
    batch = _batch('effdet', boxes=np.float32)
    efficientdet._nearest_index.cache_clear()
    _, cfg = _configs('effdet', jnp.float32, torch.float32)
    detector = build_effdet(cfg, variables=trees['effdet'], device='cpu')
    detector.detect_batch(torch.from_numpy(batch['images']))
    assert not efficientdet._nearest_index(
        4, 8, torch.device('cpu')).is_inference()
    _, state = _port_state('effdet', trees['effdet'], torch.float32,
                           train.make_optimizer())
    metrics = train.make_train_step(cfg)(state, batch)
    assert np.isfinite(float(metrics['loss']))


def test_encode_boxes_matches_jax_and_inverts_decode():
    rng = np.random.default_rng(4)
    lo = rng.uniform(0.0, 0.6, (3, 50, 2)).astype(np.float32)
    boxes = np.concatenate(
        [lo, lo + rng.uniform(0.05, 0.4, (3, 50, 2)).astype(np.float32)], -1)
    lo = rng.uniform(0.0, 0.7, (50, 2)).astype(np.float32)
    anchors = np.concatenate(
        [lo, lo + rng.uniform(0.02, 0.3, (50, 2)).astype(np.float32)], -1)
    scales = (10.0, 10.0, 5.0, 5.0)
    got = encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors),
                       scales)
    want = np.asarray(jax_encode_boxes(jnp.asarray(boxes),
                                       jnp.asarray(anchors), scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    back = decode_boxes(got, torch.from_numpy(anchors), scales)
    np.testing.assert_allclose(back.numpy(), boxes, atol=1e-6)


# anchors [6, 4]; four images of three ground truths each
MATCH_ANCHORS = np.array([[0.0, 0.0, 0.4, 0.4], [0.6, 0.6, 1.0, 1.0],
                          [0.0, 0.5, 0.5, 1.0], [0.5, 0.0, 1.0, 0.5],
                          [0.2, 0.2, 0.7, 0.7], [0.0, 0.0, 0.2, 0.2]],
                         np.float32)
MATCH_CASES = {
    # two valid ground truths whose best anchor is anchor 5: the later wins
    'duplicate claims': ([[0.01, 0.01, 0.1, 0.1], [0.0, 0.0, 0.12, 0.12],
                          [0.6, 0.6, 1.0, 1.0]], [1, 2, 3],
                         [True, True, True]),
    # an invalid ground truth on a valid one's anchor claims nothing
    'invalid ground truths': ([[0.61, 0.61, 0.99, 0.99],
                               [0.6, 0.6, 1.0, 1.0], [0.0, 0.5, 0.5, 1.0]],
                              [2, 3, 1], [True, False, False]),
    'none valid': ([[0.0, 0.0, 0.4, 0.4], [0.6, 0.6, 1.0, 1.0],
                    [0.2, 0.2, 0.7, 0.7]], [1, 2, 3], [False, False, False]),
    # IoU well below 0.5 with every anchor: forced onto its best
    'forced below 0.5': ([[0.45, 0.45, 0.5, 0.52], [0.0, 0.0, 0.0, 0.0],
                          [0.0, 0.0, 0.0, 0.0]], [2, 0, 0],
                         [True, False, False]),
}


def test_match_anchors_matches_jax():
    """cls targets and positives equal to JAX's (jitted, vmapped) on the
    hand-built cases, box targets to 1e-6 of their magnitude."""
    boxes, labels, valid = (np.array([MATCH_CASES[c][i] for c in MATCH_CASES])
                            for i in range(3))
    boxes = boxes.astype(np.float32)
    labels = labels.astype(np.int32)
    scales = (10.0, 10.0, 5.0, 5.0)
    want = [np.asarray(a) for a in jax.jit(jax.vmap(functools.partial(
        jax_train._match_anchors, jnp.asarray(MATCH_ANCHORS), scales)))(
            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))]
    got = [a.numpy() for a in train._match_anchors(
        torch.from_numpy(MATCH_ANCHORS), scales, torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(valid))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=1e-6 * np.abs(want[1]).max())
    cases = list(MATCH_CASES)
    dup = cases.index('duplicate claims')
    assert got[0][dup, 5] == 2 and got[2][dup, 5]
    assert not got[2][cases.index('none valid')].any()
    forced = cases.index('forced below 0.5')
    assert got[2][forced].sum() == 1 and got[0][forced, 4] == 2


def test_losses_match_optax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 4, (2, 30, 4)).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 30))]
    np.testing.assert_allclose(
        train._focal_loss(torch.from_numpy(logits),
                          torch.from_numpy(onehot)).numpy(),
        np.asarray(jax_train._focal_loss(jnp.asarray(logits),
                                         jnp.asarray(onehot))),
        rtol=1e-6, atol=1e-7)
    pred = rng.normal(0, 2, (2, 30, 4)).astype(np.float32)
    target = rng.normal(0, 2, (2, 30, 4)).astype(np.float32)
    np.testing.assert_allclose(
        train._huber_loss(torch.from_numpy(pred),
                          torch.from_numpy(target)).numpy(),
        np.asarray(optax.huber_loss(jnp.asarray(pred), jnp.asarray(target))),
        rtol=1e-6, atol=1e-7)


def test_trainer_is_family_aware():
    ssd_cfg = SSDConfig(dtype=torch.float32, **SSD_SMALL)
    _, effdet_cfg = _configs('effdet', jnp.float32, torch.float32)
    assert isinstance(train._model_for(effdet_cfg), efficientdet.EfficientDet)
    assert not isinstance(train._model_for(ssd_cfg),
                          efficientdet.EfficientDet)
    x = torch.tensor([[0.0, 127.0, 255.0]])
    np.testing.assert_allclose(train._normalize_for(effdet_cfg)(x).numpy(),
                               (x.numpy() - 127.0) / 128.0, rtol=1e-6)
    np.testing.assert_allclose(train._normalize_for(ssd_cfg)(x).numpy(),
                               x.numpy() * (2.0 / 255.0) - 1.0, rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.init_train_state(ssd_cfg, 0)
