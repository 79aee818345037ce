"""The port's NMS against the JAX package on the same seeded inputs: the
fused formulation with its exact suppression, and the classic per-class
modes with their greedy suppression. Keep-masks and surviving scores must
be bit-identical; classes and counts equal; boxes and scores within 1e-6
(two frameworks' exp and sigmoid may round the last f32 bit
differently)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from watsor_tpu.ops import boxes as j_boxes
from watsor_tpu.ops import nms as j_nms
from watsor_tpu.ops import nms_pallas as j_pallas
from watsor_tpu_torch.ops import nms as t_nms
from watsor_tpu_torch.ops import nms_fixed_point as t_fp
from watsor_tpu_torch.ops import nms_suppress as t_sup
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

F32_TOL = 1e-6
SCALES = (10.0, 10.0, 5.0, 5.0)


def _boxes(rng, shape, lo=0.05, hi=0.4):
    yx = rng.uniform(0, 1, shape + (2,))
    hw = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([yx, yx + hw], -1).astype(np.float32)


def _jax_keep(s, iou, thr):
    return np.asarray(j_pallas.fixed_point_suppress(
        jnp.asarray(s), jnp.asarray(iou), iou_threshold=thr,
        interpret=True))


def _torch_keep(s, iou, thr):
    """The port's plain fixed point over an IoU matrix."""
    return t_fp.fixed_point_keep(torch.tensor(s), torch.tensor(iou),
                                 thr).numpy()


def _union_case(seed, B, C, M, grid=None, dead=0):
    """Union scores [B, C, M] (on a 1/grid lattice when ``grid``, so many
    tie; ``dead`` candidates of each class retired at -inf) and the union's
    boxes [B, M, 4]."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 1, (B, C, M))
    if grid:
        s = np.floor(s * grid) / grid
    if dead:
        for b in range(B):
            for c in range(C):
                s[b, c, rng.choice(M, dead, replace=False)] = -np.inf
    return s.astype(np.float32), _boxes(rng, (B, M))


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('M', [128, 100])
@pytest.mark.parametrize('grid,dead', [(None, 0), (16, 5)])
def test_fixed_point_suppress_from_boxes_matches_jax(seed, M, grid, dead):
    """The port's entry, scores and the union's boxes in, against JAX's
    iou_matrix followed by the Pallas kernel (interpret mode): keep-masks
    bit-identical, at M = 128 and at an M that is not a multiple of 32,
    with tied scores and dead candidates."""
    s, boxes = _union_case(seed, 2, 5, M, grid, dead)
    iou = np.asarray(j_boxes.iou_matrix(jnp.asarray(boxes),
                                        jnp.asarray(boxes)))
    want = _jax_keep(s, iou, 0.5)
    got = t_fp.fixed_point_suppress(torch.from_numpy(s),
                                    torch.from_numpy(boxes), 0.5).numpy()
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_fixed_point_plain_matches_jax_kernel(seed):
    rng = np.random.default_rng(seed)
    B, C, M = 2, 6, 128
    s = rng.uniform(0, 1, (B, C, M)).astype(np.float32)
    boxes = _boxes(rng, (B, M))
    iou = np.asarray(j_boxes.iou_matrix(jnp.asarray(boxes),
                                        jnp.asarray(boxes)))
    np.testing.assert_array_equal(_torch_keep(s, iou, 0.5),
                                  _jax_keep(s, iou, 0.5))


def test_fixed_point_plain_exact_on_chain():
    """a > b > c > d overlapping in a chain: greedy keeps a and c."""
    M = 128
    boxes = np.zeros((1, M, 4), np.float32)
    for i in range(4):
        boxes[0, i] = [0.0, 0.1 * i, 0.2, 0.1 * i + 0.18]
    boxes[0, 4:] = [[0.9, 0.9, 0.91, 0.91]] * (M - 4)
    s = np.zeros((1, 1, M), np.float32)
    s[0, 0, :4] = [0.9, 0.8, 0.7, 0.6]
    iou = np.asarray(j_boxes.iou_matrix(jnp.asarray(boxes),
                                        jnp.asarray(boxes)))
    got = _torch_keep(s, iou, 0.25)
    np.testing.assert_array_equal(got, _jax_keep(s, iou, 0.25))
    keep = got[0, 0]
    assert keep[0] and not keep[1] and keep[2] and not keep[3]


def test_fixed_point_plain_equal_scores():
    """All scores tied: the lower index wins every pick."""
    rng = np.random.default_rng(7)
    B, C, M = 2, 3, 128
    s = np.full((B, C, M), 0.5, np.float32)
    s[:, 1, ::3] = 0.25
    boxes = _boxes(rng, (B, M), 0.1, 0.5)
    iou = np.asarray(j_boxes.iou_matrix(jnp.asarray(boxes),
                                        jnp.asarray(boxes)))
    got = _torch_keep(s, iou, 0.3)
    np.testing.assert_array_equal(got, _jax_keep(s, iou, 0.3))
    assert got[:, [0, 2], 0].all()          # the fully tied classes


def test_fixed_point_wrapper_on_cpu_runs_plain():
    rng = np.random.default_rng(8)
    s = torch.from_numpy(rng.uniform(0, 1, (1, 2, 40)).astype(np.float32))
    boxes = torch.from_numpy(_boxes(rng, (1, 40)))
    from watsor_tpu_torch.ops.boxes import iou_matrix
    before = t_fp.fixed_point_suppress.launches
    got = t_fp.fixed_point_suppress(s, boxes, 0.5)
    assert torch.equal(got, t_fp.fixed_point_suppress_plain(s, boxes, 0.5))
    assert torch.equal(got, t_fp.fixed_point_keep(s, iou_matrix(boxes, boxes),
                                                  0.5))
    assert t_fp.fixed_point_suppress.launches == before


def _late_inputs(seed, B=2, A=400, C=4, tie=False):
    rng = np.random.default_rng(seed)
    box_enc = rng.normal(0, 0.5, (B, A, 4)).astype(np.float32)
    logits = rng.normal(-1, 2, (B, A, C)).astype(np.float32)
    anchors = _boxes(rng, (A,), 0.02, 0.3)
    if tie:
        # equal max-logits across many anchors: the union keeps the lower
        # anchor indices, in order, and the merge sees tied scores
        logits[:, 100:300] = logits[:, 50:51]
    return box_enc, logits, anchors


@pytest.mark.parametrize('mode', ['fused', 'fused_exact',
                                  'fused_exact_pallas'])
@pytest.mark.parametrize('seed,tie', [(0, False), (1, True)])
def test_fused_late_nms_matches_jax(mode, seed, tie):
    suppression = t_nms.FUSED_SUPPRESSION[mode]
    box_enc, logits, anchors = _late_inputs(seed, tie=tie)
    want = [np.asarray(a) for a in j_nms.batched_class_aware_nms_fused_late(
        jnp.asarray(box_enc), jnp.asarray(logits), jnp.asarray(anchors),
        scales=SCALES, iou_threshold=0.5, score_threshold=0.05,
        max_detections=50, suppression=suppression)]
    got = [a.numpy() for a in t_nms.batched_class_aware_nms_fused_late(
        torch.from_numpy(box_enc), torch.from_numpy(logits),
        torch.from_numpy(anchors), scales=SCALES, iou_threshold=0.5,
        score_threshold=0.05, max_detections=50, suppression=suppression)]
    assert (want[3] > 0).all()                       # non-trivial
    np.testing.assert_array_equal(got[2], want[2])   # classes
    np.testing.assert_array_equal(got[3], want[3])   # valid
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=F32_TOL)


def test_fused_late_pads_to_max_detections():
    box_enc, logits, anchors = _late_inputs(3, A=20, C=2)
    boxes, scores, classes, valid = t_nms.batched_class_aware_nms_fused_late(
        torch.from_numpy(box_enc), torch.from_numpy(logits),
        torch.from_numpy(anchors), scales=SCALES, max_detections=100,
        suppression='greedy')
    assert boxes.shape == (2, 100, 4) and scores.shape == (2, 100)
    assert (classes[:, 40:] == 0).all() and (valid <= 40).all()


def _sorted_candidates(seed, B, C, K, grid=None):
    """Score-sorted per-class candidates [B, C, K, 4] and [B, C, K];
    ``grid`` puts the scores on a 1/grid lattice, so many tie."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, (B, C, K), 0.05, 0.5)
    scores = rng.uniform(0, 1, (B, C, K))
    if grid:
        scores = np.floor(scores * grid) / grid
    scores = -np.sort(-scores, axis=-1)
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize('B,C,K,grid', [(2, 3, 24, None), (2, 2, 100, 16),
                                        (1, 4, 128, 8), (2, 1, 130, None)])
def test_pallas_suppress_plain_matches_jax_kernel(B, C, K, grid):
    """Surviving scores bit-identical to the Pallas kernel (interpret mode,
    K padded to a multiple of 128 there), tied scores included."""
    boxes, scores = _sorted_candidates(K + C, B, C, K, grid)
    want = np.asarray(j_pallas.pallas_suppress(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, interpret=True))
    got = t_sup.pallas_suppress_plain(torch.from_numpy(boxes),
                                      torch.from_numpy(scores), 0.5).numpy()
    assert 0 < (got == 0).sum() < got.size - (scores == 0).sum()
    np.testing.assert_array_equal(got, want)


def test_pallas_suppress_wrapper_on_cpu_runs_plain():
    boxes, scores = _sorted_candidates(11, 1, 2, 40)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = t_sup.pallas_suppress.launches
    assert torch.equal(t_sup.pallas_suppress(b, s, 0.4),
                       t_sup.pallas_suppress_plain(b, s, 0.4))
    assert t_sup.pallas_suppress.launches == before


def test_greedy_keep_on_chain():
    """a > b > c > d overlapping in a chain: greedy keeps a and c; Fast-NMS
    keeps only a."""
    boxes = np.zeros((1, 1, 4, 4), np.float32)
    for i in range(4):
        boxes[0, 0, i] = [0.0, 0.1 * i, 0.2, 0.1 * i + 0.18]
    scores = np.array([[[0.9, 0.8, 0.7, 0.6]]], np.float32)
    got = t_sup.pallas_suppress_plain(torch.from_numpy(boxes),
                                      torch.from_numpy(scores), 0.25)
    np.testing.assert_array_equal(got.numpy()[0, 0],
                                  np.float32([0.9, 0.0, 0.7, 0.0]))
    from watsor_tpu_torch.ops.boxes import iou_matrix
    bt = torch.from_numpy(boxes)
    fast = t_nms._fast_keep(iou_matrix(bt, bt), 0.25)
    assert fast.numpy()[0, 0].tolist() == [True, False, False, False]


def _per_class_inputs(seed, B, A, C, grid=None):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0.2, 0.8, (B, A, 2)).astype(np.float32)
    sizes = rng.uniform(0.05, 0.35, (B, A, 2)).astype(np.float32)
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           axis=-1).clip(0, 1)
    scores = rng.uniform(0, 1, (B, A, C)).astype(np.float32)
    if grid:
        scores = (np.floor(scores * grid) / grid).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize('mode', ['exact', 'fast', 'pallas'])
@pytest.mark.parametrize('B,A,C,k,grid', [(2, 24, 3, 24, None),
                                          (1, 16, 2, 16, None),
                                          (2, 1917, 3, 100, 64)])
def test_per_class_nms_matches_jax(mode, B, A, C, k, grid):
    """The classic per-class modes (the sizes of tests/test_nms_pallas.py,
    and the SSD's 1917 anchors with top-100 per class, tied scores):
    classes and counts equal, scores and boxes within 1e-6. The IoU
    threshold stays at its default, 0.6: the JAX ``pallas`` mode fails to
    trace when it is passed (the Pallas kernel would capture it)."""
    boxes, scores = _per_class_inputs(A + C, B, A, C, grid)
    want = [np.asarray(a) for a in j_nms.batched_class_aware_nms(
        jnp.asarray(boxes), jnp.asarray(scores), score_threshold=0.05,
        max_detections=50, per_class_k=k, mode=mode)]
    got = [a.numpy() for a in t_nms.batched_class_aware_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        score_threshold=0.05, max_detections=50, per_class_k=k, mode=mode)]
    assert (want[3] > 0).all()
    np.testing.assert_array_equal(got[2], want[2])   # classes
    np.testing.assert_array_equal(got[3], want[3])   # valid
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=F32_TOL)


def test_per_class_nms_pads_and_refuses_fused_modes():
    """The per-class entry pads to ``max_detections``; it serves the fused
    modes as JAX's entry does (the early fused form, equal to JAX's on
    these inputs) and refuses a mode that neither package knows."""
    boxes, scores = _per_class_inputs(5, 1, 10, 2)
    out = t_nms.batched_class_aware_nms(torch.from_numpy(boxes),
                                        torch.from_numpy(scores),
                                        max_detections=100, mode='exact')
    assert out[0].shape == (1, 100, 4) and (out[2][:, 20:] == 0).all()
    got = [a.numpy() for a in t_nms.batched_class_aware_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        max_detections=100, mode='fused_exact')]
    want = [np.asarray(a) for a in j_nms.batched_class_aware_nms(
        jnp.asarray(boxes), jnp.asarray(scores), max_detections=100,
        mode='fused_exact')]
    assert got[0].shape == (1, 100, 4) and (got[2][:, 20:] == 0).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match='NMS mode'):
        t_nms.batched_class_aware_nms(torch.from_numpy(boxes),
                                      torch.from_numpy(scores),
                                      mode='fused_approx')


def _np(a):
    """A result array of either package as numpy, floats as f32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.is_floating_point() else a).numpy()
    return np.asarray(a, np.float32 if jnp.issubdtype(a.dtype, jnp.floating)
                      else a.dtype)


def _both(boxes, scores, dtype, mode, jax_mode=None, **kw):
    """(port, JAX) results of the per-class entry on the same numpy
    inputs, the scores in ``dtype`` ('f32' or 'bf16') on both sides;
    floats as f32 numpy."""
    ts, js = torch.from_numpy(scores), jnp.asarray(scores)
    if dtype == 'bf16':
        ts, js = ts.to(torch.bfloat16), js.astype(jnp.bfloat16)
    got = t_nms.batched_class_aware_nms(torch.from_numpy(boxes), ts,
                                        mode=mode, **kw)
    want = j_nms.batched_class_aware_nms(jnp.asarray(boxes), js,
                                         mode=jax_mode or mode, **kw)
    return [_np(a) for a in got], [_np(a) for a in want]


@pytest.mark.parametrize('mode', ['fused', 'fused_exact',
                                  'fused_exact_pallas'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('seed,grid', [(0, None), (1, None), (2, 32)])
def test_fused_modes_of_per_class_entry_match_jax(mode, dtype, seed, grid):
    """The per-class entry under each fused mode on decoded boxes and
    sigmoid scores (the early fused form) against JAX's, in f32 and bf16
    scores, tied scores included (a 1/32 grid, and 50 anchors copying one
    anchor's scores): classes and counts equal, boxes and scores within
    F32_TOL, the scores in the caller's dtype. JAX's
    ``fused_exact_pallas`` refuses bf16 scores (its Pallas kernel's
    scratch is f32), so in bf16 it is held against JAX's ``fused_exact``,
    the same fixed point."""
    boxes, scores = _per_class_inputs(seed + 40, 2, 300, 5, grid)
    scores[:, 100:150] = scores[:, 10:11]
    jax_mode = 'fused_exact' if (dtype, mode) == \
        ('bf16', 'fused_exact_pallas') else mode
    got, want = _both(boxes, scores, dtype, mode, jax_mode,
                      iou_threshold=0.5, score_threshold=0.05,
                      max_detections=50)
    assert (want[3] > 0).all()
    np.testing.assert_array_equal(got[2], want[2])   # classes
    np.testing.assert_array_equal(got[3], want[3])   # valid
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=F32_TOL)
    out = t_nms.batched_class_aware_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores).to(
            torch.bfloat16 if dtype == 'bf16' else torch.float32),
        mode=mode)
    assert out[1].dtype == (torch.bfloat16 if dtype == 'bf16'
                            else torch.float32)
    assert out[0].dtype == torch.float32 and out[2].dtype == torch.int32


def _fused(boxes, scores, **kw):
    return t_nms.batched_class_aware_nms(torch.from_numpy(boxes),
                                         torch.from_numpy(scores), **kw)


def test_fused_disjoint_boxes_match_exact():
    """tests/test_nms_fused.py:12 in the port: on disjoint boxes the fused
    mode keeps what the classic exact mode keeps."""
    boxes = np.zeros((1, 16, 4), np.float32)
    for i in range(16):
        r, c = divmod(i, 4)
        boxes[0, i] = [r * 0.25, c * 0.25, r * 0.25 + 0.2, c * 0.25 + 0.2]
    scores = np.random.RandomState(0).uniform(
        0.3, 0.9, (1, 16, 2)).astype(np.float32)
    exact = _fused(boxes, scores, per_class_k=16, mode='exact')
    fused = _fused(boxes, scores, mode='fused')
    assert int(exact[3][0]) == int(fused[3][0])
    np.testing.assert_allclose(exact[1].numpy(), fused[1].numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(exact[2].numpy(), fused[2].numpy())


def test_fused_overlap_suppressed_best_kept():
    """tests/test_nms_fused.py:31: of two overlapping boxes of one class
    the better is kept, a third apart is kept too."""
    boxes = np.zeros((1, 3, 4), np.float32)
    boxes[0, 0] = [0.1, 0.1, 0.5, 0.5]
    boxes[0, 1] = [0.12, 0.12, 0.52, 0.52]
    boxes[0, 2] = [0.6, 0.6, 0.9, 0.9]
    scores = np.zeros((1, 3, 2), np.float32)
    scores[0, :, 0] = [0.9, 0.8, 0.7]
    b, s, c, v = _fused(boxes, scores, mode='fused')
    assert int(v[0]) == 2
    assert float(s[0, 0]) == np.float32(0.9)
    assert int(c[0, 0]) == 1


def test_fused_cross_class_not_suppressed():
    """tests/test_nms_fused.py:47: one box under two classes stays twice."""
    boxes = np.tile(np.array([[0.1, 0.1, 0.5, 0.5]], np.float32),
                    (2, 1))[None]
    scores = np.zeros((1, 2, 3), np.float32)
    scores[0, 0, 0] = 0.9
    scores[0, 1, 2] = 0.8
    b, s, c, v = _fused(boxes, scores, mode='fused')
    assert int(v[0]) == 2
    assert sorted([int(c[0, 0]), int(c[0, 1])]) == [1, 3]


@pytest.mark.parametrize('mode', ['fused', 'fused_exact',
                                  'fused_exact_pallas'])
def test_fused_score_ties_keep_single(mode):
    """tests/test_nms_fused.py:60 (there under ``fused``), in every fused
    mode: identical boxes with identical scores keep one."""
    boxes = np.tile(np.array([[0.1, 0.1, 0.5, 0.5]], np.float32),
                    (3, 1))[None]
    scores = np.full((1, 3, 1), 0.8, np.float32)
    b, s, c, v = _fused(boxes, scores, mode=mode)
    assert int(v[0]) == 1, 'tie-break failed: {} kept'.format(int(v[0]))


def test_fused_padding_and_contract_shapes():
    """tests/test_nms_fused.py:69: every score under the threshold gives
    no detection, padded to ``max_detections``."""
    boxes = np.random.RandomState(1).uniform(0, 0.5, (3, 40, 4)) \
        .astype(np.float32)
    boxes[..., 2:] += 0.1
    scores = np.full((3, 40, 5), 0.001, np.float32)
    b, s, c, v = _fused(boxes, scores, mode='fused', score_threshold=0.01,
                        max_detections=50)
    assert b.shape == (3, 50, 4) and s.shape == (3, 50)
    assert int(v.sum()) == 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('suppression', ['fast', 'greedy', 'greedy_pallas'])
def test_fused_late_matches_early(dtype, suppression):
    """tests/test_nms_fused.py:79 in the port: the late form (union ranked
    on the raw logits, decode and f32 sigmoid on the union) against the
    early form on every anchor's decoded boxes and f32 sigmoid scores:
    classes and counts equal, floats within 1e-6. The box encodings are
    those of real boxes near jittered anchors; one anchor's logits repeat
    another's (the union's tie order)."""
    from watsor_tpu_torch.ops.boxes import decode_boxes, encode_boxes
    rng = np.random.RandomState(7)
    B, A, C = 3, 400, 5
    centers = rng.uniform(0.1, 0.9, (A, 2)).astype(np.float32)
    sizes = rng.uniform(0.05, 0.3, (A, 2)).astype(np.float32)
    anchors = torch.from_numpy(np.concatenate(
        [centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32))
    target = torch.from_numpy(np.clip(
        anchors.numpy()[None].repeat(B, 0) +
        rng.uniform(-0.05, 0.05, (B, A, 4)), 0, 1).astype(np.float32))
    box_enc = encode_boxes(target, anchors, scales=SCALES).to(dtype)
    logits = torch.from_numpy(
        rng.uniform(-6, 3, (B, A, C)).astype(np.float32)).to(dtype)
    logits[:, 50] = logits[:, 40]
    early = t_nms.batched_class_aware_nms_fused(
        decode_boxes(box_enc.float(), anchors, scales=SCALES),
        torch.sigmoid(logits.float()), suppression=suppression)
    late = t_nms.batched_class_aware_nms_fused_late(
        box_enc, logits, anchors, scales=SCALES, suppression=suppression)
    assert (late[3] > 0).all()
    np.testing.assert_allclose(early[0].numpy(), late[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(early[1].numpy(), late[1].numpy(), atol=1e-6)
    np.testing.assert_array_equal(early[2].numpy(), late[2].numpy())
    np.testing.assert_array_equal(early[3].numpy(), late[3].numpy())


def _chain_boxes():
    """Three boxes A > B > C by score, IoU(A, B) and IoU(B, C) about 0.45,
    IoU(A, C) about 0.14 (tests/test_nms_semantics.py:15)."""
    boxes = np.array([[[0.00, 0.00, 0.40, 1.00],
                       [0.15, 0.00, 0.55, 1.00],
                       [0.30, 0.00, 0.70, 1.00]]], np.float32)
    scores = np.array([[[0.9], [0.8], [0.7]]], np.float32)
    return boxes, scores


def test_fused_chain_divergence_from_exact():
    """tests/test_nms_semantics.py:35 in the port: greedy keeps A and C;
    Fast-NMS drops C as well; both fused greedy modes reach greedy's fixed
    point."""
    boxes, scores = _chain_boxes()
    kw = dict(iou_threshold=0.4, score_threshold=0.1, max_detections=10)
    kept = {mode: int(_fused(boxes, scores, mode=mode, **kw)[3][0])
            for mode in ('exact', 'fused', 'fused_exact',
                         'fused_exact_pallas')}
    assert kept == {'exact': 2, 'fused': 1, 'fused_exact': 2,
                    'fused_exact_pallas': 2}


def _clustered(seed, B, A, C, lo=0.2, hi=0.8, size=(0.05, 0.3)):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(lo, hi, (B, A, 2))
    sizes = rng.uniform(size[0], size[1], (B, A, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           axis=-1).clip(0, 1).astype(np.float32)
    return boxes, rng.uniform(0, 1, (B, A, C)).astype(np.float32)


def test_fused_kept_is_subset_of_exact():
    """tests/test_nms_semantics.py:51 in the port: Fast-NMS only ever
    suppresses more than greedy, so the fused kept set lies within the
    exact one (every candidate in the union, every kept one read)."""
    B, A, C = 4, 96, 3
    boxes, scores = _clustered(7, B, A, C)
    kw = dict(iou_threshold=0.5, score_threshold=0.3, max_detections=A * C)
    eb, es, ec, ev = _fused(boxes, scores, mode='exact', per_class_k=A, **kw)
    fb, fs, fc, fv = _fused(boxes, scores, mode='fused', **kw)
    for i in range(B):
        exact_set = {(float(es[i, j]), int(ec[i, j]))
                     for j in range(int(ev[i]))}
        fused_set = {(float(fs[i, j]), int(fc[i, j]))
                     for j in range(int(fv[i]))}
        assert fused_set <= exact_set, (i, fused_set - exact_set)
        assert int(fv[i]) <= int(ev[i])


@pytest.mark.parametrize('mode', ['fused_exact', 'fused_exact_pallas'])
def test_fused_exact_matches_classic_exact_when_union_covers(mode):
    """tests/test_nms_semantics.py:78 in the port: with no more anchors
    than the union holds, both fused greedy modes give exactly the classic
    greedy result, dense clusters included."""
    B, A, C = 6, 128, 4
    boxes, scores = _clustered(3, B, A, C, 0.3, 0.7, (0.1, 0.4))
    kw = dict(iou_threshold=0.5, score_threshold=0.05, max_detections=50)
    exact = _fused(boxes, scores, mode='exact', per_class_k=A, **kw)
    fused = _fused(boxes, scores, mode=mode, **kw)
    for e, f in zip(exact, fused):
        np.testing.assert_array_equal(e.numpy(), f.numpy())


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel (scores and the union's boxes in) against the plain
    version, bit for bit, with tied scores and dead candidates, at the
    main path's shapes, at ragged M and at every row width up to M = 1000
    (run on the card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    device = torch.device('cuda', 0)
    for B, C, M, dead in ((8, 2, 128, 0), (8, 90, 128, 0), (8, 2, 100, 3),
                          (3, 5, 33, 1), (2, 3, 200, 0), (2, 3, 300, 7),
                          (2, 3, 1000, 0), (1, 1, 1, 0)):
        s, boxes = _union_case(B * M + C, B, C, M, 32, dead)
        scores = torch.from_numpy(s).to(device)
        b = torch.from_numpy(boxes).to(device)
        before = t_fp.fixed_point_suppress.launches
        got = t_fp.fixed_point_suppress(scores, b, 0.5)
        assert t_fp.fixed_point_suppress.launches == before + 1
        want = t_fp.fixed_point_suppress_plain(scores, b, 0.5)
        assert torch.equal(got, want), (B, C, M)


@pytest.mark.cuda
def test_suppress_kernel_matches_plain_on_the_card():
    """The per-class kernel against the plain version, bit for bit, with
    tied scores, at the int8 path's shapes, at ragged K and at every row
    width up to K = 1000 (run on the card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    device = torch.device('cuda', 0)
    for B, C, K, grid in ((8, 2, 100, 32), (8, 90, 100, 32), (2, 3, 1000, 8),
                          (3, 5, 33, None), (2, 3, 200, 8), (2, 3, 300, None),
                          (1, 1, 1, None)):
        boxes, scores = _sorted_candidates(B * K, B, C, K, grid)
        b = torch.from_numpy(boxes).to(device)
        s = torch.from_numpy(scores).to(device)
        got = t_sup.pallas_suppress(b, s, 0.5)
        assert torch.equal(got, t_sup.pallas_suppress_plain(b, s, 0.5))


@pytest.mark.cuda
def test_kernels_decide_the_threshold_exactly_on_the_card():
    """Boxes on a 1/16 grid repeat their IoU values: with the threshold at
    the most frequent one, and at the float below it, both suppression
    kernels (which test the IoU without dividing) equal their plain
    versions bit for bit (run on the card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from watsor_tpu_torch.ops.boxes import iou_matrix
    device = torch.device('cuda', 0)
    rng = np.random.default_rng(3)
    B, C, M = 4, 3, 128
    yx = rng.integers(0, 12, (B, M, 2)) / 16
    hw = rng.integers(1, 5, (B, M, 2)) / 16
    boxes = torch.tensor(np.concatenate([yx, yx + hw], -1),
                         dtype=torch.float32)
    iou = iou_matrix(boxes, boxes).numpy()
    values, counts = np.unique(iou[(iou > 0.2) & (iou < 0.9)],
                               return_counts=True)
    at = values[counts.argmax()]
    assert counts.max() > 10
    scores = np.floor(rng.uniform(0, 1, (B, C, M)) * 16) / 16
    s = torch.tensor(scores, dtype=torch.float32, device=device)
    b = boxes.to(device)
    top = torch.tensor(-np.sort(-scores, axis=-1), dtype=torch.float32,
                       device=device)
    per_class = b[:, None].expand(B, C, M, 4).contiguous()
    for thr in (float(at), float(np.nextafter(at, np.float32(-1)))):
        assert torch.equal(t_fp.fixed_point_suppress(s, b, thr),
                           t_fp.fixed_point_suppress_plain(s, b, thr)), thr
        assert torch.equal(t_sup.pallas_suppress(per_class, top, thr),
                           t_sup.pallas_suppress_plain(per_class, top, thr)), \
            thr
