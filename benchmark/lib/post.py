"""The reference's post-processing, in plain PyTorch and NumPy: box
decoding against the anchors, the detect step's NMS (a candidate union of
the best anchors by their best watched logit, exact greedy suppression a
class over the union, the best detections over the classes), and each
camera's filters (confidence and area by label, zones of the camera's
mask by the exact pixel test). Nothing here imports the program.
"""

import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the COCO label map (index 0 unlabeled), as the configurations name labels
COCO = ('unlabeled person bicycle car motorcycle airplane bus train truck '
        'boat').split() + ['traffic light', 'fire hydrant', 'street sign',
                           'stop sign', 'parking meter'] + \
    ('bench bird cat dog horse sheep cow elephant bear zebra giraffe hat '
     'backpack umbrella shoe').split() + ['eye glasses'] + \
    'handbag tie suitcase frisbee skis snowboard'.split() + \
    ['sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
     'surfboard', 'tennis racket', 'bottle', 'plate', 'wine glass', 'cup',
     'fork', 'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich',
     'orange', 'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake',
     'chair', 'couch', 'potted plant', 'bed', 'mirror', 'dining table',
     'window', 'desk', 'toilet', 'door', 'tv', 'laptop', 'mouse', 'remote',
     'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
     'refrigerator', 'blender', 'book', 'clock', 'vase', 'scissors',
     'teddy bear', 'hair drier', 'toothbrush']
assert len(COCO) == 91


def label_index(name):
    return COCO.index(name)


def watched_labels(cfg):
    """The watched 1-based labels, ascending."""
    return sorted(label_index(name) for name in cfg['watched'])


def decode(enc, anchors, scales):
    """(ty, tx, th, tw) [..., 4] against anchors [..., 4] -> corner boxes
    clipped to [0, 1] (the TF OD faster_rcnn box coder)."""
    ha = anchors[..., 2] - anchors[..., 0]
    wa = anchors[..., 3] - anchors[..., 1]
    yc = anchors[..., 0] + 0.5 * ha + enc[..., 0] / scales[0] * ha
    xc = anchors[..., 1] + 0.5 * wa + enc[..., 1] / scales[1] * wa
    h = torch.exp(enc[..., 2] / scales[2]) * ha
    w = torch.exp(enc[..., 3] / scales[3]) * wa
    return torch.stack([yc - 0.5 * h, xc - 0.5 * w, yc + 0.5 * h,
                        xc + 0.5 * w], -1).clamp(0.0, 1.0)


def iou(a, b):
    """Pairwise IoU of boxes [..., M, 4] and [..., N, 4]."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    ih = (torch.minimum(a[..., 2], b[..., 2]) -
          torch.maximum(a[..., 0], b[..., 0])).clamp_min(0.0)
    iw = (torch.minimum(a[..., 3], b[..., 3]) -
          torch.maximum(a[..., 1], b[..., 1])).clamp_min(0.0)
    inter = ih * iw

    def area(x):
        return (x[..., 2] - x[..., 0]).clamp_min(0.0) * \
            (x[..., 3] - x[..., 1]).clamp_min(0.0)
    return inter / (area(a) + area(b) - inter).clamp_min(1e-8)


def greedy_keep(scores, boxes, threshold):
    """Greedy NMS of every (frame, class) at once: scores [B, C, M], boxes
    [B, M, 4] -> keep [B, C, M]. The best live candidate (lower index on a
    tie) is kept, and it and every candidate overlapping it by more than
    ``threshold`` leave; until none is live."""
    B, C, M = scores.shape
    over = iou(boxes, boxes) > threshold                     # [B, M, M]
    live = torch.ones_like(scores, dtype=torch.bool)
    keep = torch.zeros_like(live)
    index = torch.arange(M, device=scores.device)
    for _ in range(M):
        if not bool(live.any()):
            break
        best = torch.where(live, scores, -torch.inf).amax(-1, keepdim=True)
        pick = torch.where(live & (scores == best), index, M).amin(-1)
        has = pick < M
        pick = pick.clamp(max=M - 1)
        hit = index == pick[..., None]
        gone = torch.gather(over, 1, pick[..., None].expand(B, C, M))
        keep |= hit & has[..., None]
        live &= ~((gone | hit) & has[..., None])
    return keep


def detect(box_enc, logits, anchors, cfg, columns, labels, candidates=4):
    """The detect step on raw outputs ``box_enc`` [B, A, 4] and ``logits``
    [B, A, K] (f32): (candidates, detections, cut). Candidates are the
    decoded box [B, K, 4] and sigmoid score of each watched class [B, K, C]
    of the ``candidates`` x union best anchors by best watched logit;
    detections are (boxes [B, N, 4], scores [B, N], labels [B, N], 0 for an
    empty slot), N = max_detections; cut [B] is the union's least best
    watched logit."""
    cls = logits[..., columns]
    B, A, C = cls.shape
    M = min(cfg['union'], A)
    K = min(candidates * cfg['union'], A)
    best = cls.max(-1).values
    ranked, first = torch.sort(best, dim=-1, descending=True, stable=True)
    first = first[:, :K]
    boxes = decode(torch.gather(box_enc, 1,
                                first[..., None].expand(B, K, 4)),
                   anchors[first], cfg['box_coder_scales'])
    scores = torch.sigmoid(torch.gather(cls, 1,
                                        first[..., None].expand(B, K, C)))
    ub, us = boxes[:, :M], scores[:, :M].transpose(1, 2)    # [B, C, M]
    keep = greedy_keep(us, ub, cfg['iou_threshold'])
    kept = torch.where(keep & (us > cfg['score_threshold']), us, 0.0)
    n = min(cfg['max_detections'], C * M)
    top, idx = torch.sort(kept.reshape(B, C * M), dim=-1, descending=True,
                          stable=True)
    top, idx = top[:, :n], idx[:, :n]
    out_boxes = torch.gather(ub, 1, (idx % M)[..., None].expand(B, n, 4))
    label_of = torch.tensor(labels, device=box_enc.device)
    out_labels = torch.where(top > 0, label_of[idx // M], 0)
    return (boxes, scores), (out_boxes, top, out_labels), ranked[:, M - 1]


class Zones:
    """A camera's zones from the alpha channel of its mask image: each
    8-connected opaque region is a zone, numbered by the distance of its
    centroid from the origin; a box touches a zone when a zone pixel lies
    inside it (box corners floored and ceiled to pixels)."""

    def __init__(self, path, frame_hw, max_zones=10):
        import cv2
        image = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if image is None or image.ndim != 3 or image.shape[2] != 4:
            raise ValueError('{}: not a 32-bit mask image'.format(path))
        alpha = image[:, :, 3]
        if alpha.shape != tuple(frame_hw):
            raise ValueError('{}: mask {} for frames {}'.format(
                path, alpha.shape, frame_hw))
        count, labels = cv2.connectedComponents((alpha > 0).astype(np.uint8),
                                                connectivity=8)
        zones = []
        for z in range(1, count):
            ys, xs = np.nonzero(labels == z)
            zones.append((ys.mean() ** 2 + xs.mean() ** 2, labels == z))
        zones = [m for _, m in sorted(zones, key=lambda t: t[0])][:max_zones]
        self.count = len(zones)
        self.hw = tuple(frame_hw)
        h, w = self.hw
        self.sat = np.zeros((self.count, h + 1, w + 1), np.int64)
        for i, m in enumerate(zones):
            self.sat[i, 1:, 1:] = m.cumsum(0).cumsum(1)

    def hits(self, boxes):
        """Normalized boxes [n, 4] (f32) -> [n, zones] bool."""
        h, w = self.hw
        px = np.asarray(boxes, np.float32) * np.array([h, w, h, w],
                                                      np.float32)
        y0 = np.clip(np.floor(px[:, 0]).astype(np.int64), 0, h)
        x0 = np.clip(np.floor(px[:, 1]).astype(np.int64), 0, w)
        y1 = np.clip(np.ceil(px[:, 2]).astype(np.int64), 0, h)
        x1 = np.clip(np.ceil(px[:, 3]).astype(np.int64), 0, w)
        s = self.sat
        return (s[:, y1, x1] - s[:, y0, x1] - s[:, y1, x0] +
                s[:, y0, x0]).T > 0


class CameraFilter:
    """A camera's detect rules: confidence and area (percent) by label, and
    with a mask the zones each label is allowed in (every zone where the
    entry lists none)."""

    def __init__(self, detect, zones=None):
        self.conf, self.area, self.allowed = {}, {}, {}
        for entry in detect:
            name = next(iter(entry))
            options = entry[name]
            label = label_index(name)
            self.conf[label] = np.float32(options['confidence'] / 100.0)
            self.area[label] = np.float32(options['area'] / 100.0)
            self.allowed[label] = options.get('zones') or []
        self.zones = zones

    def zone_hits(self, boxes):
        if self.zones is None:
            return np.zeros((len(boxes), 0), bool)
        return self.zones.hits(boxes)

    def admits(self, boxes, scores, labels):
        """[n] bool: the detections this camera serves, and their zone
        hits [n, zones]."""
        boxes = np.asarray(boxes, np.float32)
        area = np.maximum(boxes[:, 2] - boxes[:, 0], np.float32(0)) * \
            np.maximum(boxes[:, 3] - boxes[:, 1], np.float32(0))
        keep = np.zeros(len(boxes), bool)
        for i, label in enumerate(labels):
            label = int(label)
            keep[i] = label in self.conf and \
                scores[i] >= self.conf[label] and area[i] >= self.area[label]
        hits = self.zone_hits(boxes)
        if self.zones is not None:
            for i, label in enumerate(labels):
                if keep[i]:
                    allowed = self.allowed[int(label)] or \
                        range(1, self.zones.count + 1)
                    keep[i] = any(1 <= z <= self.zones.count and hits[i, z - 1]
                                  for z in allowed)
        return keep, hits


def camera_filters(cfg, cameras, masked):
    """{camera: CameraFilter}: the configuration's detect rules on every
    camera, its mask on those in ``masked``."""
    zones = Zones(os.path.join(HERE, cfg['mask']), cfg['frame_hw']) \
        if masked else None
    return {camera: CameraFilter(cfg['detect'],
                                 zones if camera in masked else None)
            for camera in cameras}
