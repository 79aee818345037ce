"""Box arithmetic against anchors (counterpart of watsor_tpu/ops/boxes.py).

Boxes are ``[y_min, x_min, y_max, x_max]`` in normalized [0, 1]
coordinates; every op is batched and shape-static.
"""

import torch

# faster_rcnn box-coder scales (y, x, h, w) of the SSD checkpoints
BOX_CODER_SCALES = (10.0, 10.0, 5.0, 5.0)


def anchors_to_center(anchors):
    """[A, 4] ymin/xmin/ymax/xmax -> (ycenter, xcenter, h, w), each [A, 1]."""
    ymin, xmin, ymax, xmax = anchors.split(1, dim=-1)
    h = ymax - ymin
    w = xmax - xmin
    return ymin + 0.5 * h, xmin + 0.5 * w, h, w


def decode_boxes(rel_codes, anchors, scales=BOX_CODER_SCALES):
    """rel_codes [..., A, 4] (ty, tx, th, tw) against anchors [..., A, 4] ->
    [..., A, 4] corner boxes clipped to [0, 1]."""
    ycenter_a, xcenter_a, ha, wa = anchors_to_center(anchors)
    ty, tx, th, tw = rel_codes.split(1, dim=-1)
    ty = ty / scales[0]
    tx = tx / scales[1]
    th = th / scales[2]
    tw = tw / scales[3]
    w = torch.exp(tw) * wa
    h = torch.exp(th) * ha
    ycenter = ty * ha + ycenter_a
    xcenter = tx * wa + xcenter_a
    boxes = torch.cat([ycenter - 0.5 * h, xcenter - 0.5 * w,
                       ycenter + 0.5 * h, xcenter + 0.5 * w], dim=-1)
    return boxes.clamp(0.0, 1.0)


def box_area(boxes):
    """[..., 4] -> [...] area in normalized units."""
    return (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0) * \
        (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU: [..., M, 4] x [..., N, 4] -> [..., M, N]."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    inter_ymin = torch.maximum(a[..., 0], b[..., 0])
    inter_xmin = torch.maximum(a[..., 1], b[..., 1])
    inter_ymax = torch.minimum(a[..., 2], b[..., 2])
    inter_xmax = torch.minimum(a[..., 3], b[..., 3])
    inter = (inter_ymax - inter_ymin).clamp_min(0.0) * \
        (inter_xmax - inter_xmin).clamp_min(0.0)
    union = box_area(boxes_a)[..., :, None] + \
        box_area(boxes_b)[..., None, :] - inter
    return inter / union.clamp_min(1e-8)
