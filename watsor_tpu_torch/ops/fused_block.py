"""Fused stride-1 MobileNetV2 inverted-residual block (counterpart of
watsor_tpu/ops/fused_block.py).

1x1 expand + relu6 -> 3x3 SAME depthwise + relu6 -> linear 1x1 project,
plus the residual when asked, with BatchNorm folded into the weights. NHWC
in and out. bf16 operands, f32 sums, and bf16 rounding after the input
cast, after expand and after depthwise, at the same points as the TPU
kernel.

``fused_inverted_residual`` launches the CUDA kernel (csrc/fused_block.cu)
on a CUDA tensor and runs ``fused_inverted_residual_plain`` on a CPU tensor.
"""

import ctypes

import torch
import torch.nn.functional as F

from watsor_tpu_torch import _build

# x, x_is_bf16, we, be, wdw, bdw, wp, bp, out, B, H, W, C_in, E, C_out,
# residual, device, stream
_SIGNATURES = {'wt_fused_inverted_residual': [
    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 +
    [ctypes.c_int] * 8 + [ctypes.c_void_p]}


def fused_inverted_residual_plain(x, we, be, wdw, bdw, wp, bp,
                                  residual=False):
    """x [B, H, W, C_in]; we [C_in, E], be [E]; wdw [3, 3, E], bdw [E];
    wp [E, C_out], bp [C_out] -> [B, H, W, C_out] in x.dtype."""
    H, W = x.shape[1:3]
    we, wdw, wp = (w.to(torch.bfloat16).float() for w in (we, wdw, wp))
    xb = x.to(torch.bfloat16)
    e = (xb.float() @ we + be.float()).clamp(0.0, 6.0).to(torch.bfloat16)
    ep = F.pad(e.float(), (0, 0, 1, 1, 1, 1))        # zero SAME border
    acc = torch.zeros(e.shape, dtype=torch.float32, device=x.device)
    for dr in range(3):
        for dc in range(3):
            acc = acc + ep[:, dr:dr + H, dc:dc + W, :] * wdw[dr, dc]
    d = (acc + bdw.float()).clamp(0.0, 6.0).to(torch.bfloat16)
    p = d.float() @ wp + bp.float()
    if residual:
        p = p + xb.float()
    return p.to(x.dtype)


def fused_inverted_residual(x, we, be, wdw, bdw, wp, bp, residual=False):
    """The fused block: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. On CUDA the weights must already be bf16 and
    the biases f32 (cast once at model build)."""
    if x.device.type == 'cpu':
        return fused_inverted_residual_plain(x, we, be, wdw, bdw, wp, bp,
                                             residual)
    if x.device.type != 'cuda':
        raise ValueError('fused_inverted_residual: unsupported device {}'
                         .format(x.device))
    if x.dim() != 4:
        raise ValueError('fused_inverted_residual: x must be [B, H, W, C]')
    B, H, W, C_in = x.shape
    E = we.shape[-1]
    C_out = wp.shape[-1]
    shapes = {'we': (we, (C_in, E)), 'wdw': (wdw, (3, 3, E)),
              'wp': (wp, (E, C_out)), 'be': (be, (E,)), 'bdw': (bdw, (E,)),
              'bp': (bp, (C_out,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError('fused_inverted_residual: {} has shape {}, '
                             'expected {}'.format(name, tuple(t.shape),
                                                  shape))
        want = torch.bfloat16 if name.startswith('w') else torch.float32
        if t.dtype != want:
            raise TypeError('fused_inverted_residual: {} must be {}'
                            .format(name, want))
        if t.device != x.device or not t.is_contiguous():
            raise ValueError('fused_inverted_residual: {} must be '
                             'contiguous on {}'.format(name, x.device))
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError('fused_inverted_residual: x must be bf16 or f32')
    if not x.is_contiguous():
        raise ValueError('fused_inverted_residual: x must be contiguous NHWC')
    if residual and C_in != C_out:
        raise ValueError('fused_inverted_residual: residual needs '
                         'C_in == C_out')
    if B == 0 or B > 65535:
        raise ValueError('fused_inverted_residual: unsupported batch {}'
                         .format(B))
    out = torch.empty((B, H, W, C_out), dtype=x.dtype, device=x.device)
    launch(_build.load('fused_block', _SIGNATURES), x, we, be, wdw, bdw, wp,
           bp, out, residual)
    fused_inverted_residual.launches += 1
    return out


def launch(lib, x, we, be, wdw, bdw, wp, bp, out, residual):
    """Launch the kernel of ``lib`` (a build of csrc/fused_block.cu) on the
    current stream of x's device; the operands are already checked."""
    B, H, W, C_in = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.wt_fused_inverted_residual(
        x.data_ptr(), int(x.dtype == torch.bfloat16), we.data_ptr(),
        be.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), wp.data_ptr(),
        bp.data_ptr(), out.data_ptr(), B, H, W, C_in, we.shape[-1],
        wp.shape[-1], int(residual), x.device.index, stream),
        'fused_inverted_residual launch')


fused_inverted_residual.launches = 0
