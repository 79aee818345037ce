"""Batched box overlay: every detection of every frame drawn in a few
device operations (counterpart of watsor_tpu/ops/overlay.py:26-88).

A box border is a separable function of the pixel coordinates: for box n,

    border(y, x) = row_edge[n, y] * col_span[n, x]
                 + row_span[n, y] * col_edge[n, x]

so the colour-weighted sum over all N boxes is a batched [H, 2N] x [2N, W]
product per channel, and one more with unit weights counts the borders
that cover each pixel. Every operand is a 0/1 mask or a colour up to 255
and each sum holds at most 2N terms, so the f32 products are exact
integers, in TF32 as in full f32: the output equals the JAX function's bit
for bit. Labels are stamped on the host (output/device_render.py).
"""

import numpy as np
import torch

from watsor_tpu_torch.config.coco import COCO_COLOR_TABLE


def _edge_and_span(coord_lo, coord_hi, idx, thickness):
    """coord_lo/hi: [B, N] pixel box edges, idx: [size] f32 pixel indices
    -> (edge [B, N, size], span [B, N, size]) f32 masks along one axis."""
    lo = coord_lo[..., None]                            # [B, N, 1]
    hi = coord_hi[..., None]
    near_lo = (idx - lo).abs() < thickness
    near_hi = (idx - hi).abs() < thickness
    inside = (idx >= lo - thickness) & (idx <= hi + thickness)
    edge = (near_lo | near_hi) & inside
    return edge.float(), inside.float()


def pixel_index(h, w, device):
    """The f32 row and column indices of an [h, w] frame on ``device``;
    a caller that renders one shape often makes them once."""
    return (torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device))


@torch.inference_mode()
def render_boxes(frames_u8, boxes_px, classes, color_table, thickness=2,
                 index=None):
    """Draw class-coloured box borders into a frame batch.

    frames_u8: [B, H, W, 3] uint8; boxes_px: [B, N, 4] (ymin, xmin, ymax,
    xmax) in pixels; classes: [B, N] int32 (0 = padding, not drawn);
    color_table: [L, 3] uint8 per-label colours; ``index``: the
    ``pixel_index`` of the frames (made here without it). All on one
    device. Returns the rendered [B, H, W, 3] uint8 batch.
    """
    B, H, W, _ = frames_u8.shape
    y_idx, x_idx = index if index is not None else \
        pixel_index(H, W, frames_u8.device)
    boxes_px = boxes_px.float()
    valid = (classes > 0).float()[..., None]            # [B, N, 1]
    t = float(thickness)
    y_edge, y_span = _edge_and_span(boxes_px[..., 0], boxes_px[..., 2],
                                    y_idx, t)
    x_edge, x_span = _edge_and_span(boxes_px[..., 1], boxes_px[..., 3],
                                    x_idx, t)
    y_edge = y_edge * valid
    y_span = y_span * valid

    colors = color_table[classes.clamp(0, color_table.shape[0] - 1).long()]
    # channel weights [B, N, 4]: the three colours, then 1 for the count
    weights = torch.cat([colors.float(), torch.ones_like(colors[..., :1],
                                                         dtype=torch.float32)],
                        dim=-1)
    # rows [B, 4, 2N, H] (edge rows against column spans, span rows against
    # column edges), columns [B, 2N, W]: one product gives all four sums
    rows = torch.cat([y_edge[:, None] * weights.transpose(1, 2)[..., None],
                      y_span[:, None] * weights.transpose(1, 2)[..., None]],
                     dim=2)
    cols = torch.cat([x_span, x_edge], dim=1)
    n2 = cols.shape[1]
    sums = torch.bmm(rows.transpose(2, 3).reshape(B, 4 * H, n2), cols)
    sums = sums.view(B, 4, H, W)
    count = sums[:, 3:4]
    # a true f32 division (a reciprocal product would move pixels where
    # borders overlap)
    rendered = sums[:, :3] / count.clamp_min(1.0)
    frames = frames_u8.permute(0, 3, 1, 2).float()
    out = torch.where(count > 0.5, rendered, frames)
    # clip, then truncate toward zero, as astype(uint8) does
    out = out.clamp(0, 255).to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous()


def coco_color_table(device):
    """The COCO colour table as a [L, 3] uint8 tensor on ``device``."""
    return torch.from_numpy(np.asarray(COCO_COLOR_TABLE, np.uint8)).to(device)


def render_detections(frames_u8, boxes_px, classes, thickness=2):
    """``render_boxes`` with the COCO colour table."""
    return render_boxes(frames_u8, boxes_px, classes,
                        coco_color_table(frames_u8.device),
                        thickness=thickness)
