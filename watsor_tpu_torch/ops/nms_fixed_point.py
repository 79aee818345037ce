"""Exact greedy suppression over the fused NMS candidate union.

Counterpart of watsor_tpu/ops/nms_pallas.py ``fixed_point_suppress``. Per
class, the best live candidate (score descending, lower index on ties) is
kept, then it and every candidate whose IoU with it exceeds the threshold
retire; repeat until no candidate is live. The keep-mask is the greedy-NMS
solution and equals the Jacobi fixed point of ops/nms.py bit for bit.

``fixed_point_suppress`` launches the CUDA kernel (csrc/nms_fixed_point.cu)
on a CUDA tensor and runs ``fixed_point_suppress_plain`` on a CPU tensor.
"""

import ctypes

import torch

from watsor_tpu_torch import _build

# scores at or below this are never live (the TPU kernel's _NEG * 0.5)
_LIVE_ABOVE = -1.5e38
MAX_UNION = 1024
_SIGNATURES = {'wt_fixed_point_suppress': [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]}


def fixed_point_suppress_plain(scores_cm, iou, iou_threshold=0.6):
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


def fixed_point_suppress(scores_cm, iou, iou_threshold=0.6):
    """Greedy keep-mask [B, C, M] bool: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if scores_cm.device.type == 'cpu':
        return fixed_point_suppress_plain(scores_cm, iou, iou_threshold)
    if scores_cm.device.type != 'cuda':
        raise ValueError('fixed_point_suppress: unsupported device {}'
                         .format(scores_cm.device))
    B, C, M = scores_cm.shape
    if iou.shape != (B, M, M):
        raise ValueError('fixed_point_suppress: iou {} does not match '
                         'scores {}'.format(tuple(iou.shape),
                                            tuple(scores_cm.shape)))
    if scores_cm.dtype != torch.float32 or iou.dtype != torch.float32:
        raise TypeError('fixed_point_suppress: scores and iou must be f32')
    if iou.device != scores_cm.device:
        raise ValueError('fixed_point_suppress: scores and iou on different '
                         'devices')
    if not (scores_cm.is_contiguous() and iou.is_contiguous()):
        raise ValueError('fixed_point_suppress: inputs must be contiguous')
    if not 0 < M <= MAX_UNION or B == 0 or C == 0 or B > 65535:
        raise ValueError('fixed_point_suppress: unsupported shape {}'
                         .format(tuple(scores_cm.shape)))
    keep = torch.empty((B, C, M), dtype=torch.bool, device=scores_cm.device)
    lib = _build.load('nms_fixed_point', _SIGNATURES)
    device = scores_cm.device
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(lib.wt_fixed_point_suppress(
        scores_cm.data_ptr(), iou.data_ptr(), keep.data_ptr(),
        B, C, M, float(iou_threshold), device.index, stream),
        'fixed_point_suppress launch')
    fixed_point_suppress.launches += 1
    return keep


fixed_point_suppress.launches = 0
