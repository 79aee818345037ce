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

from watsor_tpu_torch.host import ZoneMask, coco_label_index, \
    get_alpha_channel

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
