"""Device-side resize and normalize (counterpart of
watsor_tpu/ops/preprocess.py): a separable bilinear resize as two f32
contractions with dense [out, in] interpolation matrices, then the
[-1, 1] SSD-MobileNet normalization."""

from functools import lru_cache

import numpy as np
import torch


# copied from watsor_tpu/ops/preprocess.py:21-38 (that module imports jax)
@lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] bilinear interpolation weights (align_corners
    False / half-pixel centers, matching cv2.INTER_LINEAR)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    scale = in_size / out_size
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        lo_c = min(max(lo, 0), in_size - 1)
        hi_c = min(max(lo + 1, 0), in_size - 1)
        m[o, lo_c] += 1.0 - frac
        m[o, hi_c] += frac
    return m


def resize_bilinear(images, out_h: int, out_w: int):
    """images [B, H, W, C] (any dtype) -> f32 [B, out_h, out_w, C]."""
    B, H, W, C = images.shape
    x = images.float()
    if (H, W) == (out_h, out_w):
        return x
    ly = torch.from_numpy(_interp_matrix(H, out_h)).to(images.device)
    lx = torch.from_numpy(_interp_matrix(W, out_w)).to(images.device)
    x = torch.einsum('bhwc,oh->bowc', x, ly)
    return torch.einsum('bowc,pw->bopc', x, lx)


def normalize_images(x, dtype=torch.bfloat16):
    """[0, 255] -> dtype in [-1, 1] (the TF SSD-MobileNet convention)."""
    return (x.float() * (2.0 / 255.0) - 1.0).to(dtype)


def preprocess_batch(images_u8, out_h: int, out_w: int,
                     dtype=torch.bfloat16):
    """uint8 [B, H, W, 3] -> dtype [B, out_h, out_w, 3] in [-1, 1]."""
    return normalize_images(resize_bilinear(images_u8, out_h, out_w), dtype)
