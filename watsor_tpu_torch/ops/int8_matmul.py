"""int8 matrix product with a fused requantizing epilogue (counterpart of
watsor_tpu/ops/int8_matmul.py).

    y = requant(relu6(int8(x) @ int8(w) * scale + bias))

The requantizing divide is folded into the scale and bias as the TPU kernel
folds it: with ``inv = 1 / out_scale`` (f32),

    int8_out = clip(round(clip(acc*(s*inv) + b*inv, 0, 6*inv)), -127, 127)

which can differ from ``round(y / out_scale)`` by one quantum at ties; the
int8 walk's ``conv`` and ``dot`` modes keep the divide.

``int8_matmul_requant`` launches the CUDA kernel (csrc/int8_matmul.cu)
with the launch plan of ``plan_launch`` on a CUDA tensor, and runs
``int8_matmul_requant_plain`` on a CPU tensor. Both round at the same
points: the exact int32 sum, converted to f32 once; each multiply and add
in f32; round half to even.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from watsor_tpu_torch import _build

# x, w, scale, bias, inv, hi, relu6, out, out_is_i8, M, K, N, bm, bn,
# kslice, splits, tiles, smem, device, stream
_SIGNATURES = {'wt_int8_matmul_requant': [
    ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                            ctypes.c_void_p] + [ctypes.c_int] * 11 +
    [ctypes.c_void_p]}

SMEM_LIMIT = 227 * 1024      # shared memory one block may take on sm_90
MAX_CLUSTER = 8              # the portable thread-block cluster size
SMS = 132                    # streaming multiprocessors of an H100 SXM
MIN_SLICE = 64               # the shallowest K slice a split makes
STAGES = 4                   # the ring's slots (csrc/int8_matmul.cu kStages)
WIDTHS = (16, 32, 64, 96, 128)   # the kernel's tile columns
# The plan's rule, fitted to a sweep of every plan at the int8 walk's 23
# shapes on one H100 (PERF.md): a launch gives at least two thirds of the
# SMs a block wherever K allows (a narrower tile or a split that fills the
# last third costs more than it gains); K is split only where the unsplit
# launch falls short of that, and then as far as two blocks an SM allow;
# past three blocks an SM, a block walks several row tiles.
MIN_BLOCKS = 2 * SMS // 3
MAX_SPLIT_BLOCKS = 2 * SMS
MAX_BLOCKS = 3 * SMS


class LaunchPlan(NamedTuple):
    """How csrc/int8_matmul.cu cuts one call: tiles of ``bm`` x ``bn``
    outputs, K cut into ``splits`` slices of ``kslice`` (the last one
    shorter) summed by the blocks of a thread-block cluster, at most
    ``tiles`` row tiles a block (1 when K is split), ``smem`` bytes of
    shared memory, ``blocks`` blocks."""
    bm: int
    bn: int
    splits: int
    kslice: int
    tiles: int
    smem: int
    blocks: int


def _ceil_div(a, b):
    return -(-a // b)


def _round_up(v, m):
    return _ceil_div(v, m) * m


def _layout_bytes(bm, bn, kslice, splits, tiles):
    """Shared memory of one block: csrc/int8_matmul.cu make_layout."""
    def take(offset, size):
        return _round_up(offset + size, 128)
    bk = 32 if kslice <= 32 else 64
    n_k = _ceil_div(kslice, bk)
    slots = min(STAGES, n_k * tiles)
    ring = take(0, 2 * bn * 4)                               # scale, bias
    off = take(ring, slots * bm * (bk + 16))                 # x stages
    off = take(off, (1 if n_k == 1 else slots) * bk * (bn + 16))  # raw w
    off = take(off, 2 * bn * (bk + 16))                      # transposed w
    if splits == 1:
        return take(off, bm * (bn + 16))                     # staged out
    after = take(ring, 4 * bm * bn)                          # partials
    return max(off, take(after, bm * (bn + 16)))             # staged out


def make_plan(M, K, N, bm, splits, tiles=1):
    """The plan with ``bm`` rows a tile, the narrowest of WIDTHS that
    covers N (else 128) columns, K cut into at most ``splits`` slices (a
    multiple of 32 deep, none empty) and at most ``tiles`` row tiles a
    block."""
    bn = next((b for b in WIDTHS if b >= N), WIDTHS[-1])
    kslice = _round_up(_ceil_div(K, splits), 32)
    splits = _ceil_div(K, kslice)
    tiles = 1 if splits > 1 else tiles
    return LaunchPlan(bm, bn, splits, kslice, tiles,
                      _layout_bytes(bm, bn, kslice, splits, tiles),
                      _ceil_div(_ceil_div(M, bm), tiles) * _ceil_div(N, bn) *
                      splits)


def _max_splits(K):
    return max(1, min(MAX_CLUSTER, K // MIN_SLICE))


def candidate_plans(M, K, N):
    """The plans the sweep times for a shape: 128 or 64 rows a tile, each
    split of K into slices of at least MIN_SLICE over up to MAX_CLUSTER
    blocks, and without a split 1, 2, 4 or 8 row tiles a block where that
    keeps one block an SM."""
    plans = []
    for splits in range(1, _max_splits(K) + 1):
        for bm in (128, 64):
            for tiles in (1, 2, 4, 8) if splits == 1 else (1,):
                plan = make_plan(M, K, N, bm, splits, tiles)
                if plan.splits == splits and plan not in plans and \
                        (tiles == 1 or plan.blocks >= SMS):
                    plans.append(plan)
    return plans


@functools.lru_cache(maxsize=1024)
def plan_launch(M, K, N):
    """The launch plan of one call, worked out once per shape: 128 rows a
    tile where that reaches MIN_BLOCKS without a split, else 64; no split
    where the unsplit plan reaches MIN_BLOCKS, else the most K slices that
    keep within MAX_SPLIT_BLOCKS, or the fewest that reach MIN_BLOCKS; and
    without a split, as many row tiles a block as keep within MAX_BLOCKS.
    Raises ValueError for a shape the kernel does not take."""
    if min(M, K, N) < 1 or _ceil_div(N, 128) > 65535:
        raise ValueError('int8_matmul_requant: unsupported shape M={} K={} '
                         'N={}'.format(M, K, N))
    bm = 128 if make_plan(M, K, N, 128, 1).blocks >= MIN_BLOCKS else 64
    plans = []
    for splits in range(1, _max_splits(K) + 1):
        plan = make_plan(M, K, N, bm, splits)
        if plan.splits == splits:
            plans.append(plan)
    plan = plans[0]
    if plan.blocks < MIN_BLOCKS:
        plan = max((p for p in plans if p.blocks <= MAX_SPLIT_BLOCKS),
                   key=lambda p: p.splits)
    if plan.blocks < MIN_BLOCKS:
        plan = next((p for p in plans if p.blocks >= MIN_BLOCKS), plans[-1])
    if plan.splits == 1 and plan.blocks > MAX_BLOCKS:
        plan = make_plan(M, K, N, bm, 1, _ceil_div(plan.blocks, MAX_BLOCKS))
    if plan.blocks >= 2 ** 31:
        raise ValueError('int8_matmul_requant: unsupported shape M={} K={} '
                         'N={}'.format(M, K, N))
    return plan


def requant_constants(out_scale):
    """(inv, hi) of the fold, in f32: 1 / out_scale and 6 * inv, or (1, 6)
    for a float output (``out_scale`` None)."""
    if out_scale is None:
        return np.float32(1.0), np.float32(6.0)
    inv = np.float32(1.0) / np.float32(out_scale)
    return inv, np.float32(6.0) * inv


def exact_matmul(x, w):
    """[M, K] @ [K, N] of integer-valued tensors -> the exact sums as f32,
    rounded to nearest once, as ``int32_sum.astype(f32)`` rounds them. The
    products are summed in f64, exact below 2^53; the card has no integer
    matrix product for every shape (``torch._int_mm`` refuses M <= 16)."""
    return (x.double() @ w.double()).float()


def int8_matmul_requant_plain(x_i8, w_i8, scale, bias, out_scale=None,
                              relu6=True):
    """x_i8 [M, K] int8, w_i8 [K, N] int8, scale [N] f32 (the combined
    x_scale * per-channel w_scale), bias [N] f32 -> int8 [M, N] when
    ``out_scale`` is given, else f32 [M, N]."""
    acc = exact_matmul(x_i8, w_i8)
    inv, hi = requant_constants(out_scale)
    if out_scale is not None:
        scale = scale * float(inv)
        bias = bias * float(inv)
    y = acc * scale + bias
    if relu6:
        y = y.clamp(0.0, float(hi))
    if out_scale is None:
        return y
    return torch.round(y).clamp(-127.0, 127.0).to(torch.int8)


def int8_matmul_requant(x_i8, w_i8, scale, bias, out_scale=None, relu6=True):
    """The fused product: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``out_scale`` is a host number."""
    if x_i8.device.type == 'cpu':
        return int8_matmul_requant_plain(x_i8, w_i8, scale, bias, out_scale,
                                         relu6)
    if x_i8.device.type != 'cuda':
        raise ValueError('int8_matmul_requant: unsupported device {}'.format(
            x_i8.device))
    if x_i8.dim() != 2 or w_i8.dim() != 2 or x_i8.shape[1] != w_i8.shape[0]:
        raise ValueError('int8_matmul_requant: x {} and w {} are not [M, K] '
                         'and [K, N]'.format(tuple(x_i8.shape),
                                             tuple(w_i8.shape)))
    M, K = x_i8.shape
    N = w_i8.shape[1]
    if x_i8.dtype != torch.int8 or w_i8.dtype != torch.int8:
        raise TypeError('int8_matmul_requant: x and w must be int8')
    for name, t in (('scale', scale), ('bias', bias)):
        if tuple(t.shape) != (N,) or t.dtype != torch.float32:
            raise ValueError('int8_matmul_requant: {} must be f32 [{}]'
                             .format(name, N))
    for t in (x_i8, w_i8, scale, bias):
        if t.device != x_i8.device or not t.is_contiguous():
            raise ValueError('int8_matmul_requant: operands must be '
                             'contiguous on {}'.format(x_i8.device))
    plan = plan_launch(M, K, N)
    out = torch.empty((M, N), dtype=torch.float32 if out_scale is None
                      else torch.int8, device=x_i8.device)
    launch(_build.load('int8_matmul', _SIGNATURES), x_i8, w_i8, scale, bias,
           out, out_scale, relu6, plan)
    int8_matmul_requant.launches += 1
    return out


def launch(lib, x_i8, w_i8, scale, bias, out, out_scale, relu6, plan):
    """Launch the kernel of ``lib`` (a build of csrc/int8_matmul.cu) with
    ``plan`` on the current stream of x's device; the operands are already
    checked."""
    (M, K), N = x_i8.shape, w_i8.shape[1]
    inv, hi = requant_constants(out_scale)
    device = x_i8.device
    _build.check(lib.wt_int8_matmul_requant(
        x_i8.data_ptr(), w_i8.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        float(inv), float(hi), int(relu6), out.data_ptr(),
        int(out_scale is not None), M, K, N, plan.bm, plan.bn, plan.kslice,
        plan.splits, plan.tiles, plan.smem, device.index,
        torch.cuda.current_stream(device).cuda_stream),
        'int8_matmul_requant launch')


int8_matmul_requant.launches = 0
