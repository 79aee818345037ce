"""Fixed-shape, batched, class-aware NMS (counterpart of
watsor_tpu/ops/nms.py).

The fused formulation: one class-agnostic candidate union (the top
``union_m`` anchors by max-class score), one overlap relation shared by
every class, suppression for every class at once, and a top-k merge over
classes. It comes in two forms with the same result:

- early (``batched_class_aware_nms_fused``): decoded boxes and scores of
  every anchor in, the union ranked by max-class score and gathered;
- late (``batched_class_aware_nms_fused_late``, the detect step's): box
  encodings and logits in, the union ranked by max-class logit, then
  decode and f32 sigmoid on the union only.

The per-class entry ``batched_class_aware_nms`` takes decoded boxes and
scores. Its modes ``fused``, ``fused_exact`` and ``fused_exact_pallas``
run the early fused form (suppression ``fast``, ``greedy`` and
``greedy_pallas``); its modes ``exact``, ``fast`` and ``pallas`` run the
classic per-class formulation: the top-k of each class over every anchor,
suppression within each class, and the same merge. Ties in every top-k
step go to the lower index, as ``lax.top_k`` orders them: a stable
descending sort gives that order, ``torch.topk`` promises none.

Fused suppression modes:
  ``fast``           a candidate is dropped if ANY higher-ranked same-class
                     candidate overlaps it (Fast-NMS);
  ``greedy``         classic greedy NMS, the exact fixed point;
  ``greedy_pallas``  the same result; both greedy modes run
                     ops/nms_fixed_point.fixed_point_suppress over the
                     union's boxes, the CUDA kernel on the card, which
                     builds the overlap relation itself: no [B, M, M]
                     tensor.
"""

import torch

from watsor_tpu_torch.ops.boxes import decode_boxes, iou_matrix
from watsor_tpu_torch.ops.nms_fixed_point import fixed_point_suppress
from watsor_tpu_torch.ops.nms_suppress import pallas_suppress

FUSED_SUPPRESSION = {'fused': 'fast', 'fused_exact': 'greedy',
                     'fused_exact_pallas': 'greedy_pallas'}
PER_CLASS_MODES = ('exact', 'fast', 'pallas')


def _top_k_lower_index(values, k):
    """Top-k along the last axis, ties to the lower index (lax.top_k)."""
    out, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return out[..., :k], idx[..., :k]


def batched_class_aware_nms_fused(boxes, scores, iou_threshold=0.6,
                                  score_threshold=0.005, max_detections=100,
                                  union_m=128, suppression='fast'):
    """The early fused form (watsor_tpu/ops/nms.py:67-116): boxes [B, A, 4]
    decoded, scores [B, A, C] (background removed) -> the contract of
    ``batched_class_aware_nms_fused_late``, the scores in their own
    dtype."""
    B, A, C = scores.shape
    M = min(union_m, A)

    best_score = scores.max(dim=-1).values                       # [B, A]
    _, union_idx = _top_k_lower_index(best_score, M)             # [B, M]
    union_boxes = torch.gather(boxes, 1,
                               union_idx[..., None].expand(B, M, 4))
    union_scores = torch.gather(scores, 1,
                                union_idx[..., None].expand(B, M, C))
    s = union_scores.transpose(1, 2).contiguous()                # [B, C, M]
    return _fused_suppress_merge(union_boxes, s, iou_threshold,
                                 score_threshold, max_detections,
                                 suppression)


def batched_class_aware_nms_fused_late(box_enc, logits, anchors, scales,
                                       iou_threshold=0.6,
                                       score_threshold=0.005,
                                       max_detections=100, union_m=128,
                                       suppression='fast'):
    """box_enc [B, A, 4], logits [B, A, C] (background removed), anchors
    [A, 4] -> (boxes [B, N, 4] f32, scores [B, N] f32, classes [B, N] int32
    1-based with 0 = padding, valid [B] int32), N = ``max_detections``."""
    B, A, C = logits.shape
    M = min(union_m, A)

    best_logit = logits.max(dim=-1).values                       # [B, A]
    _, union_idx = _top_k_lower_index(best_logit, M)             # [B, M]
    union_enc = torch.gather(box_enc, 1,
                             union_idx[..., None].expand(B, M, 4))
    union_logits = torch.gather(logits, 1,
                                union_idx[..., None].expand(B, M, C))
    union_anchors = anchors[union_idx]                           # [B, M, 4]
    union_boxes = decode_boxes(union_enc.float(), union_anchors,
                               scales=scales)
    # sigmoid in f32: bf16 would merge distinct logits into equal scores
    s = torch.sigmoid(union_logits.float()).transpose(1, 2).contiguous()
    return _fused_suppress_merge(union_boxes, s, iou_threshold,
                                 score_threshold, max_detections,
                                 suppression)


def _fused_suppress_merge(union_boxes, s, iou_threshold, score_threshold,
                          max_detections, suppression):
    """Suppression over the union ([B, M, 4] boxes, [B, C, M] class-major
    scores) and the merge over classes."""
    B, C, M = s.shape
    if suppression in ('greedy', 'greedy_pallas'):
        # on the card the kernel builds the overlap relation from the boxes;
        # it takes f32 scores, and widening bf16 is exact and keeps the order
        suppressed = ~fixed_point_suppress(s.float(), union_boxes,
                                           iou_threshold)
    elif suppression == 'fast':
        # higher[b, c, i, j]: candidate i outranks j for class c
        idx = torch.arange(M, device=s.device)
        higher = (s[:, :, :, None] > s[:, :, None, :]) | \
            ((s[:, :, :, None] == s[:, :, None, :]) &
             (idx[:, None] < idx[None, :]))
        iou = iou_matrix(union_boxes, union_boxes)               # [B, M, M]
        overlap = (iou > iou_threshold)[:, None, :, :]
        suppressed = (higher & overlap).any(dim=2)               # [B, C, M]
    else:
        raise ValueError('unknown suppression {!r}'.format(suppression))
    # the merge keeps the scores' dtype, as JAX's does
    kept = torch.where(~suppressed & (s > score_threshold), s,
                       torch.zeros((), dtype=s.dtype, device=s.device))

    flat = kept.reshape(B, C * M)
    n_out = min(max_detections, C * M)
    out_scores, out_idx = _top_k_lower_index(flat, n_out)        # [B, n]
    box_idx = out_idx % M
    out_classes = (out_idx // M + 1).to(torch.int32)
    out_boxes = torch.gather(union_boxes, 1,
                             box_idx[..., None].expand(B, n_out, 4))
    return _finish(out_boxes, out_scores, out_classes, max_detections)


def _finish(out_boxes, out_scores, out_classes, max_detections):
    """Zero the entries without a score, count the valid ones, and pad to
    ``max_detections``."""
    valid_mask = out_scores > 0.0
    out_classes = torch.where(valid_mask, out_classes, 0)
    out_boxes = torch.where(valid_mask[..., None], out_boxes, 0.0)
    valid = valid_mask.sum(dim=-1, dtype=torch.int32)
    pad = max_detections - out_scores.shape[-1]
    if pad > 0:
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
    return out_boxes, out_scores, out_classes, valid


def _fast_keep(iou, iou_threshold):
    """Keep i unless a higher-scored box overlaps it (Fast-NMS)."""
    max_prev = torch.triu(iou, diagonal=1).amax(dim=-2)
    return max_prev <= iou_threshold


def batched_class_aware_nms(boxes, scores, iou_threshold=0.6,
                            score_threshold=0.005, max_detections=100,
                            per_class_k=100, mode='exact'):
    """The per-class entry (watsor_tpu/ops/nms.py:236-309).

    boxes [B, A, 4] decoded, scores [B, A, C] (background removed) ->
    (boxes [B, N, 4], scores [B, N], classes [B, N] int32 1-based with
    0 = padding, valid [B] int32), N = ``max_detections``. Per class, the
    top ``per_class_k`` candidates; ``exact`` and ``pallas`` suppress them
    greedily through ops/nms_suppress.pallas_suppress (the CUDA kernel on
    the card), ``fast`` with Fast-NMS; then a top-k merge over classes.
    The fused modes run ``batched_class_aware_nms_fused`` on the same
    boxes and scores (``per_class_k`` unused), as JAX's entry does."""
    if mode in FUSED_SUPPRESSION:
        return batched_class_aware_nms_fused(
            boxes, scores, iou_threshold=iou_threshold,
            score_threshold=score_threshold, max_detections=max_detections,
            suppression=FUSED_SUPPRESSION[mode])
    if mode not in PER_CLASS_MODES:
        raise ValueError('NMS mode must be one of {}, got {!r}'.format(
            sorted(FUSED_SUPPRESSION) + list(PER_CLASS_MODES), mode))
    B, A, C = scores.shape
    k = min(per_class_k, A)

    top_scores, top_idx = _top_k_lower_index(scores.transpose(1, 2), k)
    top_scores = top_scores.contiguous()                          # [B, C, k]
    top_boxes = torch.gather(boxes[:, None].expand(B, C, A, 4), 2,
                             top_idx[..., None].expand(B, C, k, 4))
    zero = torch.zeros((), dtype=top_scores.dtype, device=scores.device)
    if mode == 'fast':
        keep = _fast_keep(iou_matrix(top_boxes, top_boxes), iou_threshold)
        kept = torch.where(keep & (top_scores > score_threshold), top_scores,
                           zero)
    else:
        surviving = pallas_suppress(top_boxes, top_scores, iou_threshold)
        kept = torch.where(surviving > score_threshold, surviving, zero)

    flat_scores = kept.reshape(B, C * k)
    flat_boxes = top_boxes.reshape(B, C * k, 4)
    n_out = min(max_detections, C * k)
    out_scores, out_idx = _top_k_lower_index(flat_scores, n_out)
    out_boxes = torch.gather(flat_boxes, 1,
                             out_idx[..., None].expand(B, n_out, 4))
    out_classes = (out_idx // k + 1).to(torch.int32)
    return _finish(out_boxes, out_scores, out_classes, max_detections)
