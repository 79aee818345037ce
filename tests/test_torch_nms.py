"""The port's fused NMS and its exact suppression against the JAX package
on the same seeded inputs. The keep-mask must be bit-identical; classes
and counts equal; boxes and scores within 1e-6 (two frameworks' exp and
sigmoid may round the last f32 bit differently)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from watsor_tpu.ops import boxes as j_boxes
from watsor_tpu.ops import nms as j_nms
from watsor_tpu.ops import nms_pallas as j_pallas
from watsor_tpu_torch.ops import nms as t_nms
from watsor_tpu_torch.ops import nms_fixed_point as t_fp

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


def test_per_class_modes_are_not_ported():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        t_nms.batched_class_aware_nms(None, None, mode='exact')


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
