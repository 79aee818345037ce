# Copy of watsor_tpu/output/effects.py: imports and paths adapted.
"""Render effects applied between the input and output frame rings.

Reference behavior (upstream watsor/output/{draw,blend,copy}.py):
bounding boxes + alpha-blended label backgrounds in per-class colors, zone
contour highlighting when a detection triggers a zone, whitening of the
masked-out region for mask visualization, and raw header/image copies.

The host implementations below (cv2) are the correctness baseline and serve
ad-hoc snapshots; the streaming hot path can instead use the batched
device overlay (watsor_tpu/ops/overlay.py) which renders all boxes of all
frames in one fused kernel.
"""

import cv2
import numpy as np

from watsor_tpu_torch.config.coco import get_coco_class


class CopyHeaderEffect:
    """Copy detections/epoch header from in-frame to out-frame."""

    def apply(self, frame_in, frame_out):
        frame_out.header[...] = frame_in.header


class CopyImageEffect:
    """Copy pixels from in-frame to out-frame."""

    def apply(self, frame_in, frame_out):
        np.copyto(frame_out.image, frame_in.image)


class DrawEffect:
    """Draw bounding boxes and labels (operates on the OUT frame in place,
    after a Copy*Effect has run)."""

    def apply(self, frame_in, frame_out):
        img = frame_out.image
        for det in frame_out.detections_view():
            style = get_coco_class(int(det['label']))
            y0, x0, y1, x1 = (int(v) for v in det['bbox'])
            cv2.rectangle(img, (x0, y0), (x1, y1), style.box_color,
                          style.box_thickness)
            text = '{} {:.0f}%'.format(style.label,
                                       float(det['confidence']) * 100.0)
            (tw, th), baseline = cv2.getTextSize(
                text, cv2.FONT_HERSHEY_SIMPLEX, style.font_scale,
                style.font_thickness)
            ty0 = max(y0 - th - baseline, 0)
            # alpha-blended label background
            patch = img[ty0:ty0 + th + baseline, x0:x0 + tw]
            if patch.size:
                overlay = np.full_like(patch, style.box_color, dtype=np.uint8)
                cv2.addWeighted(overlay, style.alpha, patch,
                                1.0 - style.alpha, 0.0, dst=patch)
            cv2.putText(img, text, (x0, ty0 + th),
                        cv2.FONT_HERSHEY_SIMPLEX, style.font_scale,
                        style.font_color, style.font_thickness,
                        cv2.LINE_AA)


class DrawEffectWithContours(DrawEffect):
    """DrawEffect + highlight the zones a detection triggered (the
    reference paints triggered zone outlines yellow,
    upstream watsor/output/draw.py:96-108)."""

    HIGHLIGHT = (255, 255, 0)

    def __init__(self, zone_mask):
        self._contours = {}
        index_map = zone_mask.index_map
        for z in range(1, zone_mask.num_zones + 1):
            m = (index_map == z).astype(np.uint8)
            contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            self._contours[z] = contours

    def apply(self, frame_in, frame_out):
        triggered = set()
        for det in frame_out.detections_view():
            n = int(det['num_zones'])
            triggered.update(int(z) for z in det['zones'][:n])
        for z in triggered:
            cv2.drawContours(frame_out.image, self._contours.get(z, ()), -1,
                             self.HIGHLIGHT, 2)
        super().apply(frame_in, frame_out)


class BlendEffect:
    """Whiten the masked-out region so viewers see where detection is
    disabled (mask visualization)."""

    def __init__(self, zone_mask, whiteness=0.7):
        # factor 1.0 inside zones, (1-whiteness) outside
        inside = zone_mask.alpha_factor
        self._scale = ((1.0 - whiteness) + whiteness * inside)[..., None] \
            .astype(np.float32)
        self._offset = (255.0 * whiteness * (1.0 - inside))[..., None] \
            .astype(np.float32)

    def apply(self, frame_in, frame_out):
        img = frame_out.image
        np.copyto(img, (img * self._scale + self._offset).astype(np.uint8))
