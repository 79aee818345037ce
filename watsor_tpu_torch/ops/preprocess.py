"""Device-side resize and normalize (counterpart of
watsor_tpu/ops/preprocess.py): a separable bilinear resize as two f32
contractions with dense [out, in] interpolation matrices, then the
[-1, 1] SSD-MobileNet normalization or the subtraction of channel means
(TF OD's ResNet v1 extractors)."""

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


@lru_cache(maxsize=64)
def _interp_tensor(in_size: int, out_size: int, device: torch.device):
    """``_interp_matrix`` on ``device``, copied there once: a step captured
    in a CUDA graph copies nothing from the host. Made outside inference
    mode, so that the train step may use what the serving step cached."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(in_size, out_size)).to(device)


def resize_bilinear(images, out_h: int, out_w: int):
    """images [B, H, W, C] (any dtype) -> f32 [B, out_h, out_w, C]."""
    B, H, W, C = images.shape
    x = images.float()
    if (H, W) == (out_h, out_w):
        return x
    ly = _interp_tensor(H, out_h, images.device)
    lx = _interp_tensor(W, out_w, images.device)
    x = torch.einsum('bhwc,oh->bowc', x, ly)
    return torch.einsum('bowc,pw->bopc', x, lx)


def normalize_images(x, dtype=torch.bfloat16):
    """[0, 255] -> dtype in [-1, 1] (the TF SSD-MobileNet convention)."""
    return (x.float() * (2.0 / 255.0) - 1.0).to(dtype)


@lru_cache(maxsize=16)
def _means_tensor(means, device):
    """The channel means as an f32 tensor on ``device``, copied there once
    (as ``_interp_tensor``)."""
    with torch.inference_mode(False):
        return torch.tensor(means, dtype=torch.float32, device=device)


def subtract_means(x, means, dtype=torch.bfloat16):
    """[0, 255] NHWC -> dtype, less the per-channel ``means`` (a tuple), in
    f32 with no scaling."""
    return (x.float() - _means_tensor(tuple(means), x.device)).to(dtype)


def preprocess_batch(images_u8, out_h: int, out_w: int,
                     dtype=torch.bfloat16):
    """uint8 [B, H, W, 3] -> dtype [B, out_h, out_w, 3] in [-1, 1]."""
    return normalize_images(resize_bilinear(images_u8, out_h, out_w), dtype)
