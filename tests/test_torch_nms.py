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
    return t_fp.fixed_point_suppress(torch.tensor(s), torch.tensor(iou),
                                     thr).numpy()


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
    iou = iou_matrix(boxes, boxes)
    before = t_fp.fixed_point_suppress.launches
    assert torch.equal(t_fp.fixed_point_suppress(s, iou, 0.5),
                       t_fp.fixed_point_suppress_plain(s, iou, 0.5))
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
    boxes, scores = _per_class_inputs(5, 1, 10, 2)
    out = t_nms.batched_class_aware_nms(torch.from_numpy(boxes),
                                        torch.from_numpy(scores),
                                        max_detections=100, mode='exact')
    assert out[0].shape == (1, 100, 4) and (out[2][:, 20:] == 0).all()
    with pytest.raises(ValueError, match='per-class'):
        t_nms.batched_class_aware_nms(torch.from_numpy(boxes),
                                      torch.from_numpy(scores),
                                      mode='fused_exact')


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against the plain version, bit for bit, with tied
    scores, at the main path's shapes (run on the card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from watsor_tpu_torch.ops.boxes import iou_matrix
    device = torch.device('cuda', 0)
    rng = np.random.default_rng(9)
    for B, C, M in ((8, 2, 128), (8, 90, 128), (2, 3, 1000)):
        s = np.floor(rng.uniform(0, 1, (B, C, M)) * 32) / 32
        scores = torch.tensor(s, dtype=torch.float32, device=device)
        boxes = torch.from_numpy(_boxes(rng, (B, M))).to(device)
        iou = iou_matrix(boxes, boxes).contiguous()
        got = t_fp.fixed_point_suppress(scores, iou, 0.5)
        assert torch.equal(got, t_fp.fixed_point_suppress_plain(scores, iou,
                                                                0.5))


@pytest.mark.cuda
def test_suppress_kernel_matches_plain_on_the_card():
    """The per-class kernel against the plain version, bit for bit, with
    tied scores, at the int8 path's shapes and at K = 1000 (run on the
    card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    device = torch.device('cuda', 0)
    for B, C, K, grid in ((8, 2, 100, 32), (8, 90, 100, 32), (2, 3, 1000, 8),
                          (3, 5, 33, None)):
        boxes, scores = _sorted_candidates(B * K, B, C, K, grid)
        b = torch.from_numpy(boxes).to(device)
        s = torch.from_numpy(scores).to(device)
        got = t_sup.pallas_suppress(b, s, 0.5)
        assert torch.equal(got, t_sup.pallas_suppress_plain(b, s, 0.5))
