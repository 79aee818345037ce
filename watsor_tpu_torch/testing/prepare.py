"""Shape-model preparation (counterpart of watsor_tpu/testing/prepare.py):
paint a synthetic shape dataset with the framework's own fixtures, label it
with the contour detector, train the small shape SSD on it, recalibrate its
BatchNorm statistics, and save it into the zoo's ``.msgpack`` format, which
the port's ``build_from_zoo`` and the JAX package's ``load_weights`` read.

    python -m watsor_tpu_torch.testing.prepare --steps 300 --out DIR \
        [--device cpu]

It trains on the current CUDA device unless ``--device`` names another.
"""

import argparse
import logging

import numpy as np
import torch

_LOGGER = logging.getLogger(__name__)

SHAPE_MODEL = 'ssd_mobilenet_v2_shapes'


def make_shape_config(input_size=96):
    """The shape model: 3 classes, width 0.35, extras of 32, f32, as the
    JAX package trains it. (The zoo's ``ssd_mobilenet_v2_shapes`` entry is
    the 300x300 width-1.0 geometry in both packages; this model is built
    from its saved weights with ``build_detector(make_shape_config(),
    variables=zoo.load_weights(dir, SHAPE_MODEL))``.)"""
    from watsor_tpu_torch.models.ssd import SSDConfig
    return SSDConfig(num_classes=3, input_size=input_size,
                     width_multiplier=0.35,
                     extra_features=(32, 32, 32, 32), dtype=torch.float32)


def generate_batch(batch, hw=(96, 96), max_boxes=4, seed=0):
    """Draw one shape an image (the Artist fixture's painter) and label the
    images analytically with the contour detector; the same seed gives the
    JAX function's arrays."""
    import cv2

    from watsor_tpu_torch.testing.shapes import (SHAPE_LABELS,
                                                 ShapeDetectorBackend)

    h, w = hw
    rng = np.random.RandomState(seed)
    detector = ShapeDetectorBackend((h, w))
    images = np.full((batch, h, w, 3), 255, np.uint8)
    gt_boxes = np.zeros((batch, max_boxes, 4), np.float32)
    gt_labels = np.zeros((batch, max_boxes), np.int32)
    gt_valid = np.zeros((batch, max_boxes), bool)

    for i in range(batch):
        size = rng.randint(min(h, w) // 4, min(h, w) // 2)
        x0 = rng.randint(0, w - size)
        y0 = rng.randint(0, h - size)
        shape = list(SHAPE_LABELS)[rng.randint(3)]
        if shape == 'triangle':
            pts = np.array([[x0 + size // 2, y0], [x0, y0 + size - 1],
                            [x0 + size - 1, y0 + size - 1]], np.int32)
            cv2.fillPoly(images[i], [pts], (0, 0, 0))
        elif shape == 'ellipse':
            cv2.ellipse(images[i], (x0 + size // 2, y0 + size // 2),
                        (size // 2, size // 3), 0, 0, 360, (0, 0, 0), -1)
        else:
            cv2.rectangle(images[i], (x0, y0),
                          (x0 + size - 1, y0 + size - 1), (0, 0, 0), -1)
        found = detector._detect_one(images[i])[:max_boxes]
        for j, (label, _conf, box) in enumerate(found):
            gt_labels[i, j] = label
            gt_boxes[i, j] = box
            gt_valid[i, j] = True
    return {'images': images, 'gt_boxes': gt_boxes,
            'gt_labels': gt_labels, 'gt_valid': gt_valid}


def train_shape_model(steps=300, batch=16, input_size=96, seed=0,
                      learning_rate=3e-3, log_every=50, device=None):
    """Train the shape model on ``device`` (None: the current CUDA device)
    from weights seeded with ``seed``, each step on a fresh batch, then
    recalibrate its BatchNorm statistics on 8 more (precise BN). Returns
    (variables, config, final_loss)."""
    from watsor_tpu_torch.models.train import (calibrate_batch_stats,
                                               init_train_state,
                                               make_optimizer,
                                               make_train_step)

    config = make_shape_config(input_size)
    state = init_train_state(config, seed,
                             make_optimizer(learning_rate=learning_rate),
                             device=device)
    step = make_train_step(config)

    loss = float('nan')
    for i in range(steps):
        metrics = step(state, generate_batch(batch, (input_size, input_size),
                                             seed=seed + i + 1))
        if (i + 1) % log_every == 0 or i == 0:
            loss = float(metrics['loss'])
            _LOGGER.info('step %d: loss %.4f (cls %.4f box %.4f)',
                         i + 1, loss, float(metrics['cls_loss']),
                         float(metrics['box_loss']))
    if steps:
        loss = float(metrics['loss'])
    # short runs leave the 0.997-momentum running averages far from the
    # trained activation statistics: recalibrate them so that the saved
    # model serves in eval mode as it trained
    calib = (generate_batch(batch, (input_size, input_size),
                            seed=seed + steps + 1 + i)['images']
             for i in range(8))
    variables = calibrate_batch_stats(config, state.variables(), calib,
                                      device=device)
    return variables, config, loss


def prepare_shape_model(out_dir, steps=300, **kw):
    """Train the shape model and save it into ``out_dir`` in the zoo's
    format. Returns (path, final_loss)."""
    from watsor_tpu_torch.models.zoo import save_weights

    variables, _, loss = train_shape_model(steps=steps, **kw)
    path = save_weights(variables, out_dir, SHAPE_MODEL)
    _LOGGER.info('shape model saved to %s (final loss %.4f)', path, loss)
    return path, loss


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Generate the synthetic shape dataset and train the '
                    'shape detection model')
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--batch', type=int, default=16)
    parser.add_argument('--out', required=True, help='model directory')
    parser.add_argument('--device', default=None,
                        help="torch device to train on (default: the "
                             "current CUDA device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    prepare_shape_model(args.out, steps=args.steps, batch=args.batch,
                        device=args.device)


if __name__ == '__main__':
    main()
