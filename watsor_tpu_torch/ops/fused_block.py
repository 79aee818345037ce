"""Fused stride-1 MobileNetV2 inverted-residual block (counterpart of
watsor_tpu/ops/fused_block.py).

1x1 expand + relu6 -> 3x3 SAME depthwise + relu6 -> linear 1x1 project,
plus the residual when asked, with BatchNorm folded into the weights. NHWC
in and out. bf16 operands, f32 sums, and bf16 rounding after the input
cast, after expand and after depthwise, at the same points as the TPU
kernel.

``fused_inverted_residual`` launches the CUDA kernel (csrc/fused_block.cu)
with the launch plan of ``plan_launch`` on a CUDA tensor, and runs
``fused_inverted_residual_plain`` on a CPU tensor.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from watsor_tpu_torch import _build

# x, x_is_bf16, we, be, wdw, bdw, wp, bp, out, B, H, W, C_in, E, C_out,
# residual, rows, cluster, smem, device, stream
_SIGNATURES = {'wt_fused_inverted_residual': [
    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 +
    [ctypes.c_int] * 11 + [ctypes.c_void_p]}

SMEM_LIMIT = 227 * 1024      # shared memory one block may take on sm_90
MAX_CLUSTER = 8              # the portable thread-block cluster size
SMS = 132                    # streaming multiprocessors of an H100 SXM
# The plan's one tunable: the fewest blocks a launch should have (one per
# SM); plans below it are taken only when no plan reaches it.
MIN_BLOCKS = SMS


class LaunchPlan(NamedTuple):
    """How csrc/fused_block.cu cuts one call: a cluster of ``cluster``
    blocks for each tile of ``rows`` output rows of each image, block k of
    a cluster on the k-th slice of the expanded channels."""
    rows: int
    cluster: int
    smem: int
    blocks: int

    def tiles(self, H):
        """Output rows [r0, r1) of each tile."""
        return [(r0, min(r0 + self.rows, H)) for r0 in range(0, H, self.rows)]

    def slices(self, E):
        """Expanded channels [e0, e1) of each rank of a cluster: whole
        chunks of 16, as evenly as they divide."""
        n = E // 16
        return [(k * n // self.cluster * 16, (k + 1) * n // self.cluster * 16)
                for k in range(self.cluster)]


def _round_up(v, m):
    return -(-v // m) * m


def _bf16_stride(k):
    """Row stride (bf16 values) of an odd number of 16-byte units."""
    return k if (k // 8) % 2 else k + 8


def _layout_bytes(rows, H, W, C_in, E, C_out, cluster):
    """Shared memory of one block: csrc/fused_block.cu make_layout."""
    def take(offset, size):
        return _round_up(offset + size, 128)
    cin_p, cout_p = _round_up(C_in, 16), _round_up(C_out, 16)
    es_max = -(-(E // 16) // cluster) * 16
    p_in_p = _round_up(min(rows + 2, H) * W, 16)
    p_out_p = _round_up(rows * W, 16)
    se = _bf16_stride(es_max)
    off = take(0, p_in_p * _bf16_stride(cin_p) * 2)         # x
    off = take(off, cin_p * se * 2)                          # expand weights
    off = take(off, p_in_p * se * 2)                         # expanded slice
    off = max(off, take(0, p_out_p * (cout_p + 4) * 4))     # f32 partial
    off = take(off, p_out_p * se * 2)                        # depthwise out
    off = take(off, es_max * _bf16_stride(cout_p) * 2)       # project weights
    off = take(off, 9 * es_max * 2)                          # depthwise taps
    off = take(off, es_max * 4)                              # expand bias
    return take(off, es_max * 4)                             # depthwise bias


def _plan_cost(plan, H, W, C_in, E, C_out):
    """A rough time of the launch, in multiply-adds of one SM: the largest
    block's work (tensor-core products with the halo rows, the depthwise
    on CUDA cores at twice the cost, 64 a byte staged from L2, 32 a byte of
    the cluster's f32 reduction, and a fixed cost a block) times the blocks
    that each of the card's block slots takes, plus one for the tail. The
    weights were fitted to the times of every (rows, cluster) of the 12
    main-path shapes at batch 1, 8 and 32 on one H100: the plan this picks
    is within a few percent of the fastest that keeps MIN_BLOCKS."""
    es = -(-(E // 16) // plan.cluster) * 16
    in_px = min(plan.rows + 2, H) * W
    px = plan.rows * W
    work = (in_px * _round_up(C_in, 16) * es + px * es * _round_up(C_out, 16)
            + 2 * 9 * px * es
            + 64 * 2 * ((C_in + C_out + 9) * es + in_px * C_in)
            + 32 * 4 * px * C_out + 400000)
    slots = SMS * min(2, (228 * 1024) // (plan.smem + 1024))
    return work * (plan.blocks / slots + 1)


@functools.lru_cache(maxsize=1024)
def plan_launch(B, H, W, C_in, E, C_out, min_blocks=MIN_BLOCKS):
    """The launch plan of one call, worked out once per shape. Raises
    ValueError when the shape is not one the kernel takes or no plan fits
    in shared memory."""
    if C_in % 8 or C_out % 8 or E % 16:
        raise ValueError('fused_inverted_residual: the kernel needs C_in and '
                         'C_out multiples of 8 and E of 16, got {}'.format(
                             (C_in, E, C_out)))
    if min(B, H, W) < 1 or B > 65535:
        raise ValueError('fused_inverted_residual: unsupported shape {}'
                         .format((B, H, W)))
    plans = []
    for cluster in range(1, min(MAX_CLUSTER, E // 16) + 1):
        for rows in range(1, H + 1):
            smem = _layout_bytes(rows, H, W, C_in, E, C_out, cluster)
            if smem <= SMEM_LIMIT:
                plans.append(LaunchPlan(rows, cluster, smem,
                                        B * -(-H // rows) * cluster))
    if not plans:
        raise ValueError('fused_inverted_residual: no launch plan fits in '
                         '{} bytes of shared memory for {}'.format(
                             SMEM_LIMIT, (B, H, W, C_in, E, C_out)))
    floor = min(min_blocks, max(p.blocks for p in plans))
    return min((p for p in plans if p.blocks >= floor),
               key=lambda p: (_plan_cost(p, H, W, C_in, E, C_out), p.blocks))


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
    plan = plan_launch(B, H, W, C_in, E, C_out)
    out = torch.empty((B, H, W, C_out), dtype=x.dtype, device=x.device)
    launch(_build.load('fused_block', _SIGNATURES), x, we, be, wdw, bdw, wp,
           bp, out, residual, plan)
    fused_inverted_residual.launches += 1
    return out


def launch(lib, x, we, be, wdw, bdw, wp, bp, out, residual, plan):
    """Launch the kernel of ``lib`` (a build of csrc/fused_block.cu) with
    ``plan`` on the current stream of x's device; the operands are already
    checked."""
    B, H, W, C_in = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.wt_fused_inverted_residual(
        x.data_ptr(), int(x.dtype == torch.bfloat16), we.data_ptr(),
        be.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), wp.data_ptr(),
        bp.data_ptr(), out.data_ptr(), B, H, W, C_in, we.shape[-1],
        wp.shape[-1], int(residual), plan.rows, plan.cluster, plan.smem,
        x.device.index, stream), 'fused_inverted_residual launch')


fused_inverted_residual.launches = 0
