"""int8 matrix product with a fused requantizing epilogue (counterpart of
watsor_tpu/ops/int8_matmul.py).

    y = requant(relu6(int8(x) @ int8(w) * scale + bias))

The requantizing divide is folded into the scale and bias as the TPU kernel
folds it: with ``inv = 1 / out_scale`` (f32),

    int8_out = clip(round(clip(acc*(s*inv) + b*inv, 0, 6*inv)), -127, 127)

which can differ from ``round(y / out_scale)`` by one quantum at ties; the
int8 walk's ``conv`` and ``dot`` modes keep the divide.

``int8_matmul_requant`` launches the CUDA kernel (csrc/int8_matmul.cu) on
a CUDA tensor and runs ``int8_matmul_requant_plain`` on a CPU tensor. Both
round at the same points: the exact int32 sum, converted to f32 once; each
multiply and add in f32; round half to even.
"""

import ctypes

import numpy as np
import torch

from watsor_tpu_torch import _build

# x, w, scale, bias, inv, hi, relu6, out, out_is_i8, M, K, N, device, stream
_SIGNATURES = {'wt_int8_matmul_requant': [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]}


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
    if M == 0 or K == 0 or N == 0 or -(-N // 64) > 65535 or \
            -(-M // 128) >= 2 ** 31:
        raise ValueError('int8_matmul_requant: unsupported shape M={} K={} '
                         'N={}'.format(M, K, N))
    inv, hi = requant_constants(out_scale)
    quantize = out_scale is not None
    out = torch.empty((M, N), dtype=torch.int8 if quantize else torch.float32,
                      device=x_i8.device)
    lib = _build.load('int8_matmul', _SIGNATURES)
    device = x_i8.device
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(lib.wt_int8_matmul_requant(
        x_i8.data_ptr(), w_i8.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        float(inv), float(hi), int(relu6), out.data_ptr(), int(quantize), M,
        K, N, device.index, stream), 'int8_matmul_requant launch')
    int8_matmul_requant.launches += 1
    return out


int8_matmul_requant.launches = 0
