"""The port's box, resize and normalize ops against the JAX package on the
same seeded inputs, and every numpy helper the port copied against its
original. Tolerances are in f32; the copies must be equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.config.coco import coco_label_index
from watsor_tpu.filters.mask import ZoneMask
from watsor_tpu.models import ssd_int8
from watsor_tpu.ops import anchors as j_anchors
from watsor_tpu.ops import boxes as j_boxes
from watsor_tpu.ops import filter_device as j_filter
from watsor_tpu.ops import preprocess as j_pre
from watsor_tpu_torch.models import mobilenet_v2 as t_mnv2
from watsor_tpu_torch.models import ssd_fused as t_fused
from watsor_tpu_torch.models import weights as t_weights
from watsor_tpu_torch.ops import anchors as t_anchors
from watsor_tpu_torch.ops import boxes as t_boxes
from watsor_tpu_torch.ops import filter_device as t_filter
from watsor_tpu_torch.ops import preprocess as t_pre

# f32 ops through two frameworks: exp and the resize contractions may
# round differently in the last bit, nothing more
F32_TOL = 1e-6

DETECT = [{'person': {'confidence': 40, 'area': 2, 'zones': [2]}},
          {'car': {'confidence': 60, 'area': 1, 'zones': []}},
          {'truck': None}]


def _random_boxes(rng, shape):
    yx = rng.uniform(0, 1, shape + (2,))
    hw = rng.uniform(0.01, 0.5, shape + (2,))
    return np.concatenate([yx, yx + hw], -1).astype(np.float32)


def _zone_mask(h=120, w=160):
    alpha = np.zeros((h, w), np.uint8)
    alpha[10:50, 10:70] = 255                 # zone 1
    alpha[70:110, 90:150] = 255               # zone 2
    return ZoneMask(alpha, (h, w, 3))


def test_decode_boxes_matches_jax():
    rng = np.random.default_rng(0)
    codes = rng.normal(0, 1, (2, 300, 4)).astype(np.float32)
    anchors = _random_boxes(rng, (300,))
    want = np.asarray(j_boxes.decode_boxes(jnp.asarray(codes),
                                           jnp.asarray(anchors)))
    got = t_boxes.decode_boxes(torch.from_numpy(codes),
                               torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_iou_matrix_matches_jax():
    rng = np.random.default_rng(1)
    a = _random_boxes(rng, (2, 50))
    b = _random_boxes(rng, (2, 70))
    want = np.asarray(j_boxes.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = t_boxes.iou_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize('hw', [(120, 160), (96, 96), (37, 301)])
def test_resize_and_normalize_match_jax(hw):
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2,) + hw + (3,), np.uint8)
    want = np.asarray(j_pre.preprocess_batch(jnp.asarray(images), 96, 96,
                                             dtype=jnp.float32))
    got = t_pre.preprocess_batch(torch.from_numpy(images), 96, 96,
                                 dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize('size,kernel,stride,want', [
    (300, 3, 2, (0, 1)), (150, 3, 2, (0, 1)), (75, 3, 2, (1, 1)),
    (38, 3, 2, (0, 1)), (19, 3, 2, (1, 1)), (5, 3, 2, (1, 1)),
    (2, 3, 2, (0, 1)), (19, 3, 1, (1, 1)), (19, 1, 1, (0, 0))])
def test_same_padding_is_tf_same(size, kernel, stride, want):
    assert t_mnv2.same_padding(size, kernel, stride) == want


@pytest.mark.parametrize('size', [9, 10])
def test_strided_conv_matches_flax_same(size):
    """A stride-2 3x3 conv pads like XLA 'SAME' at odd and even sizes."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, size, size, 4)).astype(np.float32)
    k = rng.normal(0, 1, (3, 3, 4, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), 'SAME',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC')))
    got = t_mnv2.conv_same(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(t_weights.hwio_to_oihw(k).copy()), stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_interp_matrix_copy_equals_original():
    for in_size, out_size in ((1080, 300), (300, 300), (37, 96), (96, 37)):
        np.testing.assert_array_equal(
            t_pre._interp_matrix(in_size, out_size),
            j_pre._interp_matrix(in_size, out_size))


def test_threshold_tables_copy_equals_original():
    for got, want in zip(t_filter.threshold_tables(DETECT),
                         j_filter.threshold_tables(DETECT)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('with_mask', [False, True])
def test_zone_tables_copy_equals_original(with_mask):
    zone_mask = _zone_mask() if with_mask else None
    for got, want in zip(t_filter.zone_tables(zone_mask, DETECT),
                         j_filter.zone_tables(zone_mask, DETECT)):
        np.testing.assert_array_equal(got, want)


def test_zone_refiner_copy_equals_original():
    zone_mask = _zone_mask()
    rng = np.random.default_rng(4)
    boxes = _random_boxes(rng, (40,)).clip(0, 1)
    labels = rng.choice([coco_label_index(n) for n in
                         ('person', 'car', 'truck', 'dog')], 40)
    got = t_filter.ZoneRefiner(zone_mask, DETECT)(boxes, labels)
    want = j_filter.ZoneRefiner(zone_mask, DETECT)(boxes, labels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_block_plan_copy_equals_original():
    assert t_mnv2.block_plan() == ssd_int8._block_plan()


def test_fold_unit_copy_equals_original():
    rng = np.random.default_rng(5)
    params = {'Conv_0': {'kernel': rng.normal(0, 1, (3, 3, 8, 16))},
              'BatchNorm_0': {'scale': rng.uniform(0.5, 2, 16),
                              'bias': rng.normal(0, 1, 16)}}
    stats = {'BatchNorm_0': {'mean': rng.normal(0, 1, 16),
                             'var': rng.uniform(0.1, 3, 16)}}
    for got, want in zip(t_fused.fold_unit(params, stats),
                         ssd_int8.fold_unit(params, stats)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('input_size', [300, 96, 320])
def test_anchor_copies_equal_original(input_size):
    shapes = t_anchors.ssd300_feature_shapes(input_size)
    assert shapes == j_anchors.ssd300_feature_shapes(input_size)
    assert t_anchors.anchors_per_location() == \
        j_anchors.anchors_per_location()
    np.testing.assert_array_equal(t_anchors.ssd_anchors(shapes),
                                  j_anchors.ssd_anchors(shapes))
