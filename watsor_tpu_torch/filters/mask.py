# Copy of watsor_tpu/filters/mask.py: imports and paths adapted.
"""Zone masking: PNG alpha channel -> polygonal detection zones.

Reference semantics (upstream watsor/filter/mask.py): the alpha
channel of a 32-bit PNG defines where detection is allowed; contiguous
opaque regions become numbered zones (indexed by the distance of their
centroid from the origin so numbering is stable); a detection survives if
its bbox intersects a zone allowed for its class, and the indices of every
zone it touches are recorded in the detection record.

Re-design for vectorized evaluation: instead of polygon algebra per
detection (the reference uses shapely), each zone is rasterized once into a
summed-area table, so "does bbox B intersect zone Z and by how much" is four
lookups — O(1) per (detection, zone) — and the whole filter is a numpy
broadcast. The rasterized zone-index map also ships to the device for the
fused filter step.
"""

import numpy as np

from watsor_tpu_torch.config.coco import coco_label_index
from watsor_tpu_torch.runtime.frames import MAX_ZONES


def get_alpha_channel(image):
    """Extract the alpha channel of a BGRA/RGBA image loaded with
    cv2.IMREAD_UNCHANGED; asserts the mask is really 32-bit."""
    assert image is not None, "Mask image could not be read"
    assert len(image.shape) == 3 and image.shape[2] == 4, \
        "Mask image lacks an alpha channel (must be 32-bit PNG)"
    return image[:, :, 3]


def find_zones(alpha):
    """Contiguous opaque regions -> list of binary masks ordered by the
    distance of their centroid from the origin (the reference's stable
    numbering, upstream watsor/filter/mask.py:78-88)."""
    import cv2

    binary = (alpha > 0).astype(np.uint8)
    num, labels = cv2.connectedComponents(binary)
    zones = []
    for z in range(1, num):
        m = labels == z
        ys, xs = np.nonzero(m)
        if not len(ys):
            continue
        cy, cx = ys.mean(), xs.mean()
        zones.append((cy * cy + cx * cx, m))
    zones.sort(key=lambda t: t[0])
    return [m for _, m in zones]


class ZoneMask:
    """Rasterized zones + per-zone summed-area tables for O(1) bbox
    intersection queries."""

    def __init__(self, alpha, frame_shape):
        import cv2

        h, w = frame_shape[:2]
        assert alpha.shape[0] == h and alpha.shape[1] == w, \
            "Mask size {}x{} does not match frame size {}x{}".format(
                alpha.shape[1], alpha.shape[0], w, h)
        masks = find_zones(alpha)[:MAX_ZONES]
        self.num_zones = len(masks)
        self.shape = (h, w)
        # zone index map for rendering / device filtering: 0 = no zone
        self.index_map = np.zeros((h, w), np.uint8)
        for i, m in enumerate(masks):
            self.index_map[m] = i + 1
        # integral images, one per zone: [Z, h+1, w+1]
        self._sat = np.zeros((self.num_zones, h + 1, w + 1), np.int64)
        for i, m in enumerate(masks):
            self._sat[i, 1:, 1:] = np.cumsum(np.cumsum(m, axis=0), axis=1)
        # alpha-derived factor for the blend visualization effect
        self.alpha_factor = (alpha.astype(np.float32) / 255.0)

    def bbox_zone_overlap(self, bboxes):
        """bboxes [N, 4] pixel (ymin, xmin, ymax, xmax) -> [N, Z] count of
        zone pixels inside each bbox (four SAT lookups per pair)."""
        n = len(bboxes)
        if n == 0 or self.num_zones == 0:
            return np.zeros((n, self.num_zones), np.int64)
        h, w = self.shape
        y0 = np.clip(np.floor(bboxes[:, 0]).astype(np.int64), 0, h)
        x0 = np.clip(np.floor(bboxes[:, 1]).astype(np.int64), 0, w)
        y1 = np.clip(np.ceil(bboxes[:, 2]).astype(np.int64), 0, h)
        x1 = np.clip(np.ceil(bboxes[:, 3]).astype(np.int64), 0, w)
        sat = self._sat  # [Z, h+1, w+1]
        return (sat[:, y1, x1] - sat[:, y0, x1] -
                sat[:, y1, x0] + sat[:, y0, x0]).T


class MaskFilter:
    """Keep detections whose bbox touches an allowed zone; record the
    indices of every zone touched (1-based in the detection record)."""

    def __init__(self, detect_config, zone_mask: ZoneMask):
        self._zone_mask = zone_mask
        # per-label allow-list: None = all zones allowed
        from watsor_tpu_torch.config.coco import iter_detect_entries
        self._allowed = {}
        for label, _, options in iter_detect_entries(detect_config):
            zones = options.get('zones') or []
            self._allowed[label] = set(zones) if zones else None

    def __call__(self, detections, frame_shape):
        n = len(detections)
        keep = np.zeros(n, bool)
        if n == 0:
            return keep
        overlap = self._zone_mask.bbox_zone_overlap(detections['bbox'])
        for i in range(n):
            touched = np.nonzero(overlap[i] > 0)[0] + 1  # 1-based
            zones = touched[:MAX_ZONES]
            detections['zones'][i, :len(zones)] = zones
            detections['num_zones'][i] = len(zones)
            if not len(zones):
                continue
            allowed = self._allowed.get(int(detections['label'][i]))
            if allowed is None:
                keep[i] = True
            else:
                keep[i] = bool(allowed.intersection(zones.tolist()))
        return keep
