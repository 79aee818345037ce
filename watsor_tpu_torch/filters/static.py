# Copy of watsor_tpu/filters/static.py: imports and paths adapted.
"""Stateless per-detection filters: confidence and minimum-area.

Reference semantics (upstream watsor/filter/confidence.py:5-19,
area.py:5-26): thresholds are configured per class in percent; a detection
whose class is not configured is dropped. Where the reference tests one
ctypes struct at a time in Python, these filters evaluate the whole
detections record-array with one vectorized expression — and the same
thresholds are exported as dense per-label lookup tables
(:meth:`thresholds_table`) so the fused device step can apply them inside
the jitted program (SURVEY.md §7 stage 6).
"""

import numpy as np

from watsor_tpu_torch.config.coco import (COCO_CLASSES, DEFAULT_AREA,
          DEFAULT_CONFIDENCE, coco_label_index)


def _per_label_table(detect_config, key, default, fill):
    """[num_labels] table of per-class thresholds; unconfigured labels get
    ``fill`` (which encodes "drop")."""
    from watsor_tpu_torch.config.coco import iter_detect_entries
    table = np.full(len(COCO_CLASSES), fill, np.float32)
    for label, _, options in iter_detect_entries(detect_config):
        table[label] = options.get(key, default)
    return table


class ConfidenceFilter:
    """Keep detections whose confidence meets the per-class threshold."""

    def __init__(self, detect_config):
        # thresholds are percents in config, confidences are [0, 1]
        self._min_confidence = _per_label_table(
            detect_config, 'confidence', DEFAULT_CONFIDENCE,
            fill=np.inf) / 100.0

    def thresholds_table(self):
        return self._min_confidence

    def __call__(self, detections, frame_shape=None):
        labels = np.clip(detections['label'], 0, len(COCO_CLASSES) - 1)
        return detections['confidence'] >= self._min_confidence[labels]


class AreaFilter:
    """Keep detections whose bbox area is at least the configured percent of
    the frame area."""

    def __init__(self, detect_config):
        self._min_area_pct = _per_label_table(
            detect_config, 'area', DEFAULT_AREA, fill=np.inf)

    def thresholds_table(self):
        return self._min_area_pct

    def __call__(self, detections, frame_shape):
        h, w = frame_shape[:2]
        bbox = detections['bbox']
        area = np.maximum(bbox[:, 2] - bbox[:, 0], 0) * \
            np.maximum(bbox[:, 3] - bbox[:, 1], 0)
        area_pct = area * (100.0 / (h * w))
        labels = np.clip(detections['label'], 0, len(COCO_CLASSES) - 1)
        return area_pct >= self._min_area_pct[labels]
