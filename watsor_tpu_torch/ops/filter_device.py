"""Device-side detection filtering (counterpart of
watsor_tpu/ops/filter_device.py): per-camera confidence and area
thresholds and the zone test on a downsampled summed-area table, batched
per frame row so frames of different cameras carry their own tables.

  conf_table [B, L]              min confidence per label (inf = unwatched)
  area_table [B, L]              min bbox area as a fraction of the frame
  zone_sat   [B, Z, g+1, g+1]    per-zone summed-area tables (0 = no zones)
  zone_allow [B, Z, L] bool      which zones admit which labels

The numpy table builders are copies: their original module imports jax.
"""

import numpy as np
import torch

from watsor_tpu_torch.config.coco import (COCO_CLASSES, DEFAULT_AREA,
                                          DEFAULT_CONFIDENCE,
                                          iter_detect_entries)
from watsor_tpu_torch.runtime.frames import MAX_ZONES

ZONE_GRID = 96

NUM_LABELS = len(COCO_CLASSES)


# copied from watsor_tpu/ops/filter_device.py:38-46
def threshold_tables(detect_config):
    """Per-camera [L] confidence (0-1) and area-fraction tables; labels not
    configured get +inf (drop)."""
    conf = np.full(NUM_LABELS, np.inf, np.float32)
    area = np.full(NUM_LABELS, np.inf, np.float32)
    for label, _, options in iter_detect_entries(detect_config):
        conf[label] = options.get('confidence', DEFAULT_CONFIDENCE) / 100.0
        area[label] = options.get('area', DEFAULT_AREA) / 100.0
    return conf, area


# copied from watsor_tpu/ops/filter_device.py:49-79
def zone_tables(zone_mask, detect_config, max_zones=MAX_ZONES,
                grid=ZONE_GRID):
    """ZoneMask -> ([Z, grid+1, grid+1] SATs of the downsampled zone masks,
    [Z, L] allow matrix). When ``zone_mask`` is None returns zeros (zones
    disabled: every detection passes the zone test)."""
    import cv2

    sats = np.zeros((max_zones, grid + 1, grid + 1), np.float32)
    allow = np.zeros((max_zones, NUM_LABELS), bool)
    if zone_mask is None:
        return sats, allow
    for z in range(1, zone_mask.num_zones + 1):
        mask = (zone_mask.index_map == z).astype(np.float32)
        # over-approximate: a cell is marked when any zone pixel falls in
        # it, and the device query expands box corners outward, so the
        # device never drops a detection the full-resolution test keeps;
        # ZoneRefiner removes the false keeps of the boundary band
        small = cv2.resize(mask, (grid, grid),
                           interpolation=cv2.INTER_AREA) > 0.0
        sats[z - 1, 1:, 1:] = np.cumsum(np.cumsum(small, axis=0), axis=1)
    # per-label allow lists (empty zones list = all zones allowed)
    for label, _, options in iter_detect_entries(detect_config):
        zones = options.get('zones') or []
        if zones:
            for z in zones:
                if 1 <= z <= max_zones:
                    allow[z - 1, label] = True
        else:
            allow[:zone_mask.num_zones, label] = True
    return sats, allow


# copied from watsor_tpu/ops/filter_device.py:82-125
class ZoneRefiner:
    """Exact full-resolution zone pass over device-filtered survivors: the
    device zone test over-approximates, so the few keeps in the <=1-cell
    boundary band are re-tested with the full-res integral image."""

    def __init__(self, zone_mask, detect_config, max_zones=MAX_ZONES):
        self._zone_mask = zone_mask
        znum = zone_mask.num_zones
        self.max_zones = max_zones
        # [L, Z] allow matrix (empty zones list = every zone allowed),
        # mirroring filters/mask.MaskFilter._allowed
        allow = np.zeros((NUM_LABELS, znum), bool)
        for label, _, options in iter_detect_entries(detect_config):
            zones = options.get('zones') or []
            if zones:
                for z in zones:
                    if 1 <= z <= znum:
                        allow[label, z - 1] = True
            else:
                allow[label, :] = True
        self._allow = allow

    def __call__(self, boxes_norm, labels):
        """boxes_norm [n,4] normalized ymin/xmin/ymax/xmax; labels [n]
        int -> (keep [n] bool, zones_hit [n, max_zones] bool), exact."""
        n = len(boxes_norm)
        hit_out = np.zeros((n, self.max_zones), bool)
        if n == 0:
            return np.zeros(0, bool), hit_out
        h, w = self._zone_mask.shape
        px = np.asarray(boxes_norm, np.float32) * \
            np.array([h, w, h, w], np.float32)
        overlap = self._zone_mask.bbox_zone_overlap(px)      # [n, znum]
        hit = overlap > 0
        labels = np.clip(np.asarray(labels, np.int64), 0, NUM_LABELS - 1)
        keep = (hit & self._allow[labels]).any(axis=1)
        hit_out[:, :hit.shape[1]] = hit
        return keep, hit_out


def apply_filters_device_indexed(boxes, scores, classes, conf_all, area_all,
                                 zone_sat_all, zone_allow_all, row_idx):
    """:func:`apply_filters_device` with each row's tables gathered on the
    device from per-camera stores by ``row_idx`` [B]."""
    row_idx = row_idx.long()
    return apply_filters_device(boxes, scores, classes, conf_all[row_idx],
                                area_all[row_idx], zone_sat_all[row_idx],
                                zone_allow_all[row_idx])


def apply_filters_device(boxes, scores, classes, conf_table, area_table,
                         zone_sat, zone_allow):
    """boxes [B, N, 4] normalized, scores [B, N], classes [B, N] int32
    (0 = padding) -> (scores, classes, zones_hit [B, N, Z] bool, valid [B]
    int32), dropped detections zeroed; shapes stay static."""
    B, N, _ = boxes.shape
    Z = zone_sat.shape[1]
    grid = zone_sat.shape[2] - 1
    labels = classes.long().clamp(0, NUM_LABELS - 1)

    min_conf = torch.gather(conf_table, 1, labels)               # [B, N]
    min_area = torch.gather(area_table, 1, labels)
    area = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0) * \
        (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    keep = (scores >= min_conf) & (area >= min_area) & (classes > 0)

    # zone test: integral-image lookups on the downsampled grid
    y0 = torch.floor(boxes[..., 0] * grid).clamp(0, grid).long()
    x0 = torch.floor(boxes[..., 1] * grid).clamp(0, grid).long()
    y1 = torch.ceil(boxes[..., 2] * grid).clamp(0, grid).long()
    x1 = torch.ceil(boxes[..., 3] * grid).clamp(0, grid).long()
    sat = zone_sat.reshape(B, Z, (grid + 1) * (grid + 1))

    def corner(yy, xx):
        flat = (yy * (grid + 1) + xx)[:, None, :].expand(B, Z, N)
        return torch.gather(sat, 2, flat)                        # [B, Z, N]

    total = corner(y1, x1) - corner(y0, x1) - corner(y1, x0) + \
        corner(y0, x0)
    zones_hit = total.transpose(1, 2) > 0.0                      # [B, N, Z]

    zones_enabled = (zone_sat != 0.0).flatten(1).any(dim=1)      # [B]
    allow_nl = torch.gather(zone_allow.transpose(1, 2), 1,
                            labels[..., None].expand(B, N, Z))   # [B, N, Z]
    zone_ok = (zones_hit & allow_nl).any(dim=-1)
    keep = keep & (zone_ok | ~zones_enabled[:, None])

    out_scores = torch.where(keep, scores, 0.0)
    out_classes = torch.where(keep, classes, 0)
    zones_hit = zones_hit & keep[..., None]
    valid = keep.sum(dim=-1, dtype=torch.int32)
    return out_scores, out_classes, zones_hit, valid
