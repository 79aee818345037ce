"""Classic per-class greedy suppression over score-sorted top-k candidates.

Counterpart of watsor_tpu/ops/nms_pallas.py ``pallas_suppress``. For each
(image, class), the candidates come sorted by score; walking them in that
order, a kept candidate retires every later candidate whose IoU with it
exceeds the threshold (``_greedy_keep`` of watsor_tpu/ops/nms.py). The
result is the score where kept and 0 where suppressed.

``pallas_suppress`` launches the CUDA kernel (csrc/nms_suppress.cu) on a
CUDA tensor and runs ``pallas_suppress_plain`` on a CPU tensor.
"""

import ctypes

import torch

from watsor_tpu_torch import _build
from watsor_tpu_torch.ops.boxes import iou_matrix

MAX_K = 1024
_SIGNATURES = {'wt_nms_suppress': [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


def greedy_keep(iou, iou_threshold):
    """iou [..., K, K] of score-sorted boxes -> keep [..., K] bool: K
    vectorized steps, each retiring the later boxes that a kept box
    overlaps (``_greedy_keep`` of watsor_tpu/ops/nms.py)."""
    K = iou.shape[-1]
    overlap = iou > iou_threshold
    later = torch.ones((K, K), dtype=torch.bool,
                       device=iou.device).triu(diagonal=1)
    keep = torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)
    for i in range(K):
        suppress = overlap[..., i, :] & later[i] & keep[..., i:i + 1]
        keep = keep & ~suppress
    return keep


def pallas_suppress_plain(top_boxes, top_scores, iou_threshold=0.6):
    """top_boxes [B, C, K, 4] f32, top_scores [B, C, K] f32 sorted
    descending -> surviving scores [B, C, K] f32 (suppressed = 0)."""
    keep = greedy_keep(iou_matrix(top_boxes, top_boxes), iou_threshold)
    return torch.where(keep, top_scores, top_scores.new_zeros(()))


def pallas_suppress(top_boxes, top_scores, iou_threshold=0.6):
    """Surviving scores [B, C, K]: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if top_scores.device.type == 'cpu':
        return pallas_suppress_plain(top_boxes, top_scores, iou_threshold)
    if top_scores.device.type != 'cuda':
        raise ValueError('pallas_suppress: unsupported device {}'.format(
            top_scores.device))
    if top_scores.dim() != 3:
        raise ValueError('pallas_suppress: scores must be [B, C, K]')
    B, C, K = top_scores.shape
    if tuple(top_boxes.shape) != (B, C, K, 4):
        raise ValueError('pallas_suppress: boxes {} do not match scores {}'
                         .format(tuple(top_boxes.shape),
                                 tuple(top_scores.shape)))
    if top_boxes.dtype != torch.float32 or top_scores.dtype != torch.float32:
        raise TypeError('pallas_suppress: boxes and scores must be f32')
    if top_boxes.device != top_scores.device:
        raise ValueError('pallas_suppress: boxes and scores on different '
                         'devices')
    if not (top_boxes.is_contiguous() and top_scores.is_contiguous()) or \
            top_boxes.data_ptr() % 16:
        raise ValueError('pallas_suppress: inputs must be contiguous (boxes '
                         '16-byte aligned)')
    if not 0 < K <= MAX_K or B * C == 0 or B * C >= 2 ** 31:
        raise ValueError('pallas_suppress: unsupported shape {}'.format(
            tuple(top_scores.shape)))
    out = torch.empty_like(top_scores)
    lib = _build.load('nms_suppress', _SIGNATURES)
    device = top_scores.device
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(lib.wt_nms_suppress(
        top_boxes.data_ptr(), top_scores.data_ptr(), out.data_ptr(), B * C,
        K, float(iou_threshold), device.index, stream),
        'pallas_suppress launch')
    pallas_suppress.launches += 1
    return out


pallas_suppress.launches = 0
