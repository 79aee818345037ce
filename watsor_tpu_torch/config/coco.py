# Copy of watsor_tpu/config/coco.py: imports and paths adapted.
"""COCO label registry: index <-> name <-> draw style.

Mirrors the public surface of the reference registry
(upstream watsor/config/coco.py:14-131): the standard 91-entry COCO
label map (index 0 = 'unlabeled'), deterministic per-class colors, and a
`get_coco_class` lookup that falls back to 'unlabeled'.

The color table here additionally ships as a device-friendly uint8 array
(`COCO_COLOR_TABLE`) so the TPU overlay kernel can gather per-class colors
without host round trips.
"""

from collections import namedtuple

import numpy as np

CocoClass = namedtuple('CocoClass', [
    'label',
    'box_color',
    'font_color',
    'box_thickness',
    'font_thickness',
    'font_scale',
    'alpha',
])

# The standard COCO paper label map (91 entries incl. the 'unlabeled'
# background class and the unused placeholder names). Detection models emit
# `class_id + 1` so index 1 == 'person', matching the reference contract
# (upstream watsor/detection/edge_tpu.py:49).
COCO_CLASSES = [
    'unlabeled',
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'street sign',
    'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse',
    'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe', 'hat',
    'backpack', 'umbrella', 'shoe', 'eye glasses', 'handbag', 'tie',
    'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite',
    'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'plate', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'mirror', 'dining table', 'window',
    'desk', 'toilet', 'door', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'blender', 'book', 'clock', 'vase', 'scissors',
    'teddy bear', 'hair drier', 'toothbrush',
]

NUM_CLASSES = len(COCO_CLASSES)

# Deterministic per-class RGB colors (seed 255 like the reference so rendered
# streams look identical across implementations).
COCO_COLOR_TABLE = (
    np.random.RandomState(255)
    .uniform(0, 255, size=(NUM_CLASSES, 3))
    .astype(np.uint8)
)

_COCO_DICTIONARY = {
    idx: CocoClass(
        label,
        box_color=tuple(int(c) for c in COCO_COLOR_TABLE[idx]),
        font_color=(255, 255, 255),
        box_thickness=1,
        font_thickness=1,
        font_scale=0.5,
        alpha=0.55,
    )
    for idx, label in enumerate(COCO_CLASSES)
}

_LABEL_TO_INDEX = {label: idx for idx, label in enumerate(COCO_CLASSES)}


def get_coco_class(idx):
    """Look up a COCO class by index, returning 'unlabeled' if unknown."""
    return _COCO_DICTIONARY.get(idx, _COCO_DICTIONARY[0])


def coco_label_index(label):
    """Label name -> index, or 0 ('unlabeled') if unknown."""
    return _LABEL_TO_INDEX.get(label, 0)


# per-class filter defaults (the reference's schema defaults,
# upstream watsor/config/schema.py:71-109) — the single source the
# host cascade AND the device tables read, so they cannot diverge
DEFAULT_CONFIDENCE = 50.0     # percent
DEFAULT_AREA = 10.0           # percent of the frame


def iter_detect_entries(detect_config):
    """Yield ``(label, class_name, options)`` for every known class of a
    camera's ``detect:`` list — the one parse loop for the whole filter
    stack (entries are single-key dicts whose value may be None)."""
    for entry in detect_config:
        name = next(iter(entry))
        options = entry[name] or {}
        label = coco_label_index(name)
        if label:
            yield label, name, options
