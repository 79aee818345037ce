"""Fixed-shape, batched, class-aware NMS in the fused formulation
(counterpart of watsor_tpu/ops/nms.py:117-233).

One class-agnostic candidate union (the top ``union_m`` anchors by
max-class logit), decode and f32 sigmoid on that union only, one shared
IoU matrix, suppression for every class at once, and a top-k merge over
classes. Ties in both top-k steps go to the lower index, as ``lax.top_k``
orders them: a stable descending sort gives that order, ``torch.topk``
promises none.

Suppression modes:
  ``fast``           a candidate is dropped if ANY higher-ranked same-class
                     candidate overlaps it (Fast-NMS);
  ``greedy``         classic greedy NMS, the exact fixed point;
  ``greedy_pallas``  the same result; both greedy modes run
                     ops/nms_fixed_point.fixed_point_suppress, the CUDA
                     kernel on the card.
"""

import torch

from watsor_tpu_torch.ops.boxes import decode_boxes, iou_matrix
from watsor_tpu_torch.ops.nms_fixed_point import fixed_point_suppress

FUSED_SUPPRESSION = {'fused': 'fast', 'fused_exact': 'greedy',
                     'fused_exact_pallas': 'greedy_pallas'}


def _top_k_lower_index(values, k):
    """Top-k along the last axis, ties to the lower index (lax.top_k)."""
    out, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return out[..., :k], idx[..., :k]


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
    iou = iou_matrix(union_boxes, union_boxes)                   # [B, M, M]
    if suppression in ('greedy', 'greedy_pallas'):
        suppressed = ~fixed_point_suppress(s, iou, iou_threshold)
    elif suppression == 'fast':
        # higher[b, c, i, j]: candidate i outranks j for class c
        idx = torch.arange(M, device=s.device)
        higher = (s[:, :, :, None] > s[:, :, None, :]) | \
            ((s[:, :, :, None] == s[:, :, None, :]) &
             (idx[:, None] < idx[None, :]))
        overlap = (iou > iou_threshold)[:, None, :, :]
        suppressed = (higher & overlap).any(dim=2)               # [B, C, M]
    else:
        raise ValueError('unknown suppression {!r}'.format(suppression))
    kept = torch.where(~suppressed & (s > score_threshold), s,
                       torch.zeros((), device=s.device))

    flat = kept.reshape(B, C * M)
    n_out = min(max_detections, C * M)
    out_scores, out_idx = _top_k_lower_index(flat, n_out)        # [B, n]
    box_idx = out_idx % M
    out_classes = (out_idx // M + 1).to(torch.int32)
    out_boxes = torch.gather(union_boxes, 1,
                             box_idx[..., None].expand(B, n_out, 4))

    valid_mask = out_scores > 0.0
    out_classes = torch.where(valid_mask, out_classes, 0)
    out_boxes = torch.where(valid_mask[..., None], out_boxes, 0.0)
    valid = valid_mask.sum(dim=-1, dtype=torch.int32)
    if n_out < max_detections:
        pad = max_detections - n_out
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
    return out_boxes, out_scores, out_classes, valid


def batched_class_aware_nms(boxes, scores, mode='exact', **kwargs):
    """The classic per-class NMS modes of watsor_tpu/ops/nms.py (``exact``,
    ``fast``, ``pallas``) are not ported yet; see ROADMAP.md."""
    raise NotImplementedError(
        "per-class NMS mode {!r} is not ported to watsor_tpu_torch yet "
        "(ROADMAP.md, queue A); use nms: fused or fused_exact".format(mode))
