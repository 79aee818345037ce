"""The port's card workloads, as chip_smoke.py and
``python -m watsor_tpu_torch.profile_step`` drive them.

ssd_mobilenet_v2 at 300x300 (1917 anchors, 90 classes), random weights
from a seed, over the watched labels {person, car}, with device filters for
BATCH cameras of 1920x1080 frames, the first of them with the repository's
demo zone mask (config/porch_mask.png). Two paths:

- the main path: bf16 activations, ``nms: fused_exact``, the fused-block
  walk (WATSOR_FUSED_BLOCKS=1);
- the int8 path: WATSOR_QUANTIZE=int8_full with
  WATSOR_INT8_POINTWISE=pallas, calibrated on seeded frames, bf16 heads,
  ``nms: exact``.
"""

import os

import numpy as np
import torch

from watsor_tpu_torch.config.coco import coco_label_index
from watsor_tpu_torch.filters.mask import ZoneMask, get_alpha_channel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = 'ssd_mobilenet_v2'
BATCH = 8
FRAME_HW = (1080, 1920)
WATCHED = ('person', 'car')
DETECT = [{'person': {'confidence': 10, 'area': 1}},
          {'car': {'confidence': 10, 'area': 1, 'zones': [1, 2]}}]
MASK_PATH = os.path.join(ROOT, 'config', 'porch_mask.png')
# (H=W, C_in, E, C_out) of the 12 fused blocks of MobileNetV2 at 300x300
FUSED_SHAPES = [(75, 24, 144, 24)] + [(38, 32, 192, 32)] * 2 + \
    [(19, 64, 384, 64)] * 3 + [(19, 64, 384, 96)] + [(19, 96, 576, 96)] * 2 + \
    [(10, 160, 960, 160)] * 2 + [(10, 160, 960, 320)]
# the card's peaks for a kernel's bound (one H100 SXM at 700 W: NVIDIA's
# data sheet, dense): device memory bytes/s and operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {'bf16': 989e12, 'f32': 67e12, 'int8': 1979e12}


class Bound:
    """The least time the card could take for some work: the bytes moved
    once over the memory rate against the operations over the peak rate of
    their type (each type on its own units), the larger of the two."""

    def __init__(self):
        self.bytes_ms = 0.0
        self.ops_ms = 0.0

    def add(self, nbytes, **ops):
        """One call: ``nbytes`` read or written once, ``ops`` counts by
        type (bf16, f32, int8). Calls add up."""
        self.bytes_ms += 1e3 * nbytes / HBM_BYTES_S
        self.ops_ms += max([1e3 * n / PEAK_OPS_S[kind]
                            for kind, n in ops.items()] + [0.0])
        return self

    @property
    def ms(self):
        return max(self.bytes_ms, self.ops_ms)

    def update(self, entry):
        entry['bound_ms'] = self.ms
        entry['bound_by'] = 'bytes' if self.bytes_ms >= self.ops_ms \
            else 'operations'


def watched_labels():
    return {coco_label_index(name) for name in WATCHED}


def build_main_path_detector(device, fused=True, seed=0):
    """The slice's detector on ``device``: the fused walk, or with
    ``fused=False`` the plain model (convolutions with BatchNorm)."""
    from watsor_tpu_torch.models.ssd_fused import build_fused_detector
    from watsor_tpu_torch.models.zoo import build_from_zoo
    detector = build_from_zoo(MODEL, None, seed=seed,
                              active_labels=watched_labels(),
                              nms_mode='fused_exact', dtype=torch.bfloat16,
                              device=device)
    return build_fused_detector(detector) if fused else detector


def calibration_frames(size=300, n=BATCH, seed=0):
    """Seeded uint8 calibration frames [n, size, size, 3]."""
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


def build_int8_path_detector(device, calib, seed=0):
    """The int8 path's detector on ``device``, calibrated on ``calib``."""
    from watsor_tpu_torch.models.ssd_int8 import build_int8_detector
    from watsor_tpu_torch.models.zoo import build_from_zoo
    detector = build_from_zoo(MODEL, None, seed=seed,
                              active_labels=watched_labels(),
                              nms_mode='exact', dtype=torch.bfloat16,
                              device=device)
    return build_int8_detector(detector, calib, pointwise='pallas')


def int8_pointwise_calls(batch=BATCH, size=300):
    """(M, K, N, int8 output, relu6) of each int8_matmul_requant call of one
    int8 forward in forward order (38 at any input size): the expands,
    block13's expand, the head and the extras' 1x1 units give int8 with
    relu6; the projects int8 without relu6, or f32 where a residual adds."""
    from watsor_tpu_torch.models.mobilenet_v2 import TAP_BLOCK, block_plan
    from watsor_tpu_torch.models.ssd import SSDConfig

    def down(h):                                  # a stride-2 'SAME' conv
        return -(-h // 2)
    h = down(size)
    channels = 32
    calls = []
    for index, expand, features, strides in block_plan():
        hidden = channels * expand
        if expand != 1:
            calls.append((batch * h * h, channels, hidden, True, True))
        if strides == 2:
            h = down(h)
        residual = index != TAP_BLOCK and strides == 1 and \
            channels == features
        calls.append((batch * h * h, hidden, features, not residual, False))
        channels = features
    calls.append((batch * h * h, channels, 1280, True, True))
    channels = 1280
    for features in SSDConfig().extra_features:
        calls.append((batch * h * h, channels, features // 2, True, True))
        h = down(h)
        channels = features
    return calls


def int8_call_work(M, K, N, quantize):
    """(bytes, int8 operations) of one int8_matmul_requant call for
    ``Bound.add``: int8 x and w read once, f32 scale and bias, the int8 or
    f32 output written once; 2MKN int8 operations."""
    return M * K + K * N + 8 * N + M * N * (1 if quantize else 4), \
        2 * M * K * N


def int_mm_operand(x, w):
    """w in a layout torch._int_mm takes with x, and its name: as it is,
    else column-major, which cuBLASLt asks for at some shapes. Call it
    outside any timed call. torch._int_mm is a yardstick of kernel 4's
    product; the port never calls it."""
    try:
        torch._int_mm(x, w)
        return w, 'row-major'
    except RuntimeError:
        wt = w.t().contiguous().t()
        torch._int_mm(x, wt)
        return wt, 'column-major'


def demo_zone_mask(frame_hw=FRAME_HW):
    """The repository's demo porch mask, scaled to the frame size."""
    import cv2
    image = cv2.imread(MASK_PATH, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise FileNotFoundError(MASK_PATH)
    alpha = cv2.resize(get_alpha_channel(image), (frame_hw[1], frame_hw[0]),
                       interpolation=cv2.INTER_NEAREST)
    return ZoneMask(alpha, frame_hw)


def camera_filters(cameras, frame_hw=FRAME_HW):
    """(tables, refiners) for TorchDetectorBackend: DETECT on every camera,
    the demo zone mask on the first."""
    from watsor_tpu_torch.ops.filter_device import (ZoneRefiner,
                                                    threshold_tables,
                                                    zone_tables)
    tables, refiners = {}, {}
    for i, camera in enumerate(cameras):
        mask = demo_zone_mask(frame_hw) if i == 0 else None
        conf, area = threshold_tables(DETECT)
        zone_sat, zone_allow = zone_tables(mask, DETECT)
        tables[camera] = (conf, area, zone_sat, zone_allow)
        if mask is not None:
            refiners[camera] = ZoneRefiner(mask, DETECT)
    return tables, refiners


def cudnn_block(x, we, be, wdw, bdw, wp, bp, residual):
    """The fused block as cuDNN runs it: three bf16 channels-last
    convolutions with the relu6 clamps (and the residual add). Timed as
    kernel 2's yardstick; the port never calls it."""
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)                   # NCHW view, channels last
    cl = torch.channels_last
    w1 = we.t()[:, :, None, None].contiguous(memory_format=cl)
    w2 = wdw.permute(2, 0, 1)[:, None].contiguous(memory_format=cl)
    w3 = wp.t()[:, :, None, None].contiguous(memory_format=cl)
    b1, b2, b3 = (b.to(torch.bfloat16) for b in (be, bdw, bp))

    def run():
        e = F.conv2d(xc, w1, b1).clamp_(0, 6)
        d = F.conv2d(e, w2, b2, padding=1, groups=w2.shape[0]).clamp_(0, 6)
        p = F.conv2d(d, w3, b3)
        return p + xc if residual else p
    return run
