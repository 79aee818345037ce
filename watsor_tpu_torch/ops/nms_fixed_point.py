"""Exact greedy suppression over the fused NMS candidate union.

Counterpart of watsor_tpu/ops/nms_pallas.py ``fixed_point_suppress`` and of
the IoU matrix that watsor_tpu/ops/nms.py builds for it. Per class, the
best live candidate (score descending, lower index on ties) is kept, then
it and every candidate whose IoU with it exceeds the threshold retire;
repeat until no candidate is live. The keep-mask is the greedy-NMS solution
and equals the Jacobi fixed point of ops/nms.py bit for bit.

``fixed_point_suppress(scores_cm, boxes)`` takes the union's boxes and
launches the CUDA kernel (csrc/nms_fixed_point.cu), which builds the
overlap relation on chip, for a CUDA tensor; for a CPU tensor it runs
``fixed_point_suppress_plain``: ``iou_matrix`` followed by
``fixed_point_keep``, the plain fixed point over an IoU matrix.
"""

import ctypes

import torch

from watsor_tpu_torch import _build
from watsor_tpu_torch.ops.boxes import iou_matrix

# scores at or below this are never live (the TPU kernel's _NEG * 0.5)
_LIVE_ABOVE = -1.5e38
MAX_UNION = 1024
_SIGNATURES = {'wt_fixed_point_suppress': [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]}


def fixed_point_keep(scores_cm, iou, iou_threshold=0.6):
    """scores_cm [B, C, M] f32, iou [B, M, M] f32 -> keep [B, C, M] bool.

    Plain PyTorch: one vectorized pick-and-retire step per iteration over
    every (image, class); it stops when no class has a live candidate."""
    B, C, M = scores_cm.shape
    overlap = iou > iou_threshold                             # [B, M, M]
    alive = scores_cm > _LIVE_ABOVE
    keep = torch.zeros_like(alive)
    idx = torch.arange(M, device=scores_cm.device)
    neg_inf = torch.tensor(float('-inf'), device=scores_cm.device)
    for _ in range(M):
        if not bool(alive.any()):
            break
        live = torch.where(alive, scores_cm, neg_inf)
        best = live.max(dim=-1, keepdim=True).values
        is_best = alive & (scores_cm == best)
        pick = torch.where(is_best, idx, M).min(dim=-1).values    # [B, C]
        onehot = idx == pick[..., None]                       # none if M
        rows = torch.gather(
            overlap, 1,
            pick.clamp(max=M - 1)[..., None].expand(B, C, M))  # [B, C, M]
        rows = rows & (pick < M)[..., None]
        keep |= onehot
        alive &= ~(rows | onehot)
    return keep


def fixed_point_suppress_plain(scores_cm, boxes, iou_threshold=0.6):
    """scores_cm [B, C, M] f32, boxes [B, M, 4] f32 -> keep [B, C, M] bool:
    the kernel's plain version, ``iou_matrix`` and ``fixed_point_keep``."""
    return fixed_point_keep(scores_cm, iou_matrix(boxes, boxes),
                            iou_threshold)


def launch(lib, scores_cm, boxes, keep, iou_threshold):
    """Launch the kernel of ``lib`` (csrc/nms_fixed_point.cu, or another
    build of it) on checked tensors, into ``keep``."""
    B, C, M = scores_cm.shape
    device = scores_cm.device
    _build.check(lib.wt_fixed_point_suppress(
        scores_cm.data_ptr(), boxes.data_ptr(), keep.data_ptr(), B, C, M,
        float(iou_threshold), device.index,
        torch.cuda.current_stream(device).cuda_stream),
        'fixed_point_suppress launch')


def fixed_point_suppress(scores_cm, boxes, iou_threshold=0.6):
    """Greedy keep-mask [B, C, M] bool of scores_cm [B, C, M] f32 over the
    union's boxes [B, M, 4] f32: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if scores_cm.device.type == 'cpu':
        return fixed_point_suppress_plain(scores_cm, boxes, iou_threshold)
    if scores_cm.device.type != 'cuda':
        raise ValueError('fixed_point_suppress: unsupported device {}'
                         .format(scores_cm.device))
    B, C, M = scores_cm.shape
    if tuple(boxes.shape) != (B, M, 4):
        raise ValueError('fixed_point_suppress: boxes {} do not match '
                         'scores {}'.format(tuple(boxes.shape),
                                            tuple(scores_cm.shape)))
    if scores_cm.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError('fixed_point_suppress: scores and boxes must be f32')
    if boxes.device != scores_cm.device:
        raise ValueError('fixed_point_suppress: scores and boxes on '
                         'different devices')
    if not (scores_cm.is_contiguous() and boxes.is_contiguous()) or \
            boxes.data_ptr() % 16:
        raise ValueError('fixed_point_suppress: inputs must be contiguous '
                         '(boxes 16-byte aligned)')
    if not 0 < M <= MAX_UNION or B * C == 0 or B * C >= 2 ** 31:
        raise ValueError('fixed_point_suppress: unsupported shape {}'
                         .format(tuple(scores_cm.shape)))
    keep = torch.empty((B, C, M), dtype=torch.bool, device=scores_cm.device)
    launch(_build.load('nms_fixed_point', _SIGNATURES), scores_cm, boxes,
           keep, iou_threshold)
    fixed_point_suppress.launches += 1
    return keep


fixed_point_suppress.launches = 0
