"""The port's batched box overlay (ops/overlay.py) against the JAX
package's, on the same seeded inputs: every output byte equal. All
operands of its products are 0/1 masks or colours up to 255, so the f32
sums are exact and the two must agree bit for bit. Also the three
behaviours of tests/test_overlay.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from watsor_tpu.ops import overlay as j_overlay
from watsor_tpu_torch.ops.overlay import (pixel_index, render_boxes,
                                          render_detections)

B, H, W, N = 3, 48, 64, 100


def _inputs(seed):
    """Frames, 100 box slots a frame (about 30 valid, the rest class-0
    padding; overlapping boxes and boxes past every edge) and a colour
    table."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    yx = rng.uniform(-12, [H + 4, W + 4], (B, N, 2))
    hw = rng.uniform(1, 40, (B, N, 2))
    boxes = np.concatenate([yx, yx + hw], -1).astype(np.float32)
    classes = np.where(rng.uniform(size=(B, N)) < 0.3,
                       rng.integers(1, 95, (B, N)), 0).astype(np.int32)
    table = rng.integers(0, 256, (91, 3), np.uint8)
    return frames, boxes, classes, table


@pytest.mark.parametrize('thickness', [1, 2, 3])
def test_render_boxes_equals_jax(thickness):
    frames, boxes, classes, table = _inputs(thickness)
    want = np.asarray(j_overlay.render_boxes(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(classes),
        jnp.asarray(table), thickness=thickness))
    got = render_boxes(torch.from_numpy(frames), torch.from_numpy(boxes),
                       torch.from_numpy(classes), torch.from_numpy(table),
                       thickness=thickness).numpy()
    assert got.dtype == np.uint8 and got.shape == frames.shape
    assert (want != frames).mean() > 0.3, 'the borders must cover pixels'
    np.testing.assert_array_equal(got, want)
    # the caller's pixel index gives the same bytes
    again = render_boxes(torch.from_numpy(frames), torch.from_numpy(boxes),
                         torch.from_numpy(classes), torch.from_numpy(table),
                         thickness=thickness,
                         index=pixel_index(H, W, torch.device('cpu')))
    np.testing.assert_array_equal(again.numpy(), want)


def test_render_detections_equals_jax():
    """The COCO colour table; labels past the table clamp to its last row,
    as the JAX function's do."""
    frames, boxes, classes, _ = _inputs(7)
    want = np.asarray(j_overlay.render_detections(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(classes)))
    got = render_detections(torch.from_numpy(frames), torch.from_numpy(boxes),
                            torch.from_numpy(classes)).numpy()
    np.testing.assert_array_equal(got, want)


def _render(frames, boxes, classes, table, **kw):
    return render_boxes(torch.from_numpy(frames), torch.from_numpy(boxes),
                        torch.from_numpy(classes), torch.from_numpy(table),
                        **kw).numpy()


def test_draws_border_only_inside_box_extent():
    frames = np.zeros((1, 32, 32, 3), np.uint8)
    boxes = np.zeros((1, 2, 4), np.float32)
    boxes[0, 0] = [8, 8, 24, 24]
    classes = np.zeros((1, 2), np.int32)
    classes[0, 0] = 1
    table = np.array([[0, 0, 0], [200, 10, 10]], np.uint8)
    out = _render(frames, boxes, classes, table, thickness=1)
    assert out[0, 8, 16, 0] > 150          # top edge coloured (R)
    assert out[0, 16, 8, 0] > 150          # left edge coloured
    assert out[0, 16, 16].sum() == 0       # interior untouched
    assert out[0, 2, 2].sum() == 0         # outside untouched


def test_padding_class_zero_not_drawn():
    frames = np.zeros((1, 16, 16, 3), np.uint8)
    boxes = np.zeros((1, 1, 4), np.float32)
    boxes[0, 0] = [2, 2, 12, 12]
    classes = np.zeros((1, 1), np.int32)   # padding
    table = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
    assert _render(frames, boxes, classes, table).sum() == 0


def test_batch_isolation():
    frames = np.zeros((2, 16, 16, 3), np.uint8)
    boxes = np.zeros((2, 1, 4), np.float32)
    boxes[0, 0] = [4, 4, 12, 12]
    classes = np.zeros((2, 1), np.int32)
    classes[0, 0] = 1                       # only image 0 has a box
    table = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
    out = _render(frames, boxes, classes, table)
    assert out[0].sum() > 0
    assert out[1].sum() == 0
