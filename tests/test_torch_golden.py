"""The port's detect step on the bundled photographs, held to the stored
photo goldens (tests/data/goldens/ssd_mobilenet_v2.json).

The goldens were made on the CPU in f32 from the JAX package's PRNGKey(0)
weights (watsor_tpu/testing/golden.py ``build_golden_detector``). The same
tree is carried across with the port's weight bridge, and the port's f32
``detect_batch`` runs the photographs that tests/test_golden_e2e.py runs,
at full width (300x300, 90 classes, ``nms: fused_exact``):

- f32 against the goldens with ``golden.match_records``: the same label,
  IoU above 0.5, and the score within 5e-3;
- bf16 against the port's own f32 result: the same labels in the same
  places, the score within BF16_SCORE_TOL.

JAX only builds the weight tree; its detector does not run.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.models.zoo import build_from_zoo as jax_build_from_zoo
from watsor_tpu.testing import golden
from watsor_tpu_torch.models.ssd import build_detector
from watsor_tpu_torch.models.zoo import MODEL_REGISTRY

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGE_DIR = os.path.join(HERE, 'data', 'images')
MODEL = 'ssd_mobilenet_v2'
TOP = 20                  # detections read a photo, as test_golden_e2e.py
# bf16 rounds every activation of about 70 layers (2^-9 relative each),
# and the sigmoid of the union is taken in f32: the bf16 scores stay within
# the goldens' own score tolerance of the f32 ones (7e-4 apart at most on
# these photographs)
BF16_SCORE_TOL = 5e-3


@pytest.fixture(scope='module')
def variables():
    """The JAX package's f32 PRNGKey(0) tree, as the goldens were made."""
    jax_det = jax_build_from_zoo(MODEL, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax_det.params)


@pytest.fixture(scope='module')
def photos():
    return golden.load_photo_batch(IMAGE_DIR)


def _port_records(variables, photos, dtype):
    batch, names = photos
    detector = build_detector(MODEL_REGISTRY[MODEL]._replace(dtype=dtype),
                              variables=variables, device='cpu')
    out = detector.detect_batch(torch.from_numpy(batch))
    records = golden.detections_to_records(
        *(t.numpy() for t in (out.boxes, out.scores, out.classes,
                              out.valid)), top=TOP)
    return dict(zip(names, records))


@pytest.fixture(scope='module')
def port_f32(variables, photos):
    return _port_records(variables, photos, torch.float32)


def test_f32_port_matches_the_stored_goldens(port_f32, photos):
    stored = golden.load_goldens(os.path.join(HERE, 'data', 'goldens',
                                              MODEL + '.json'))
    assert stored['backend'] == 'cpu' and stored['dtype'] == 'float32'
    problems = []
    for name in photos[1]:
        expected = stored['images'][name]
        assert expected, 'stored golden for {} is empty'.format(name)
        problems += ['[{}] {}'.format(name, p) for p in
                     golden.match_records(expected, port_f32[name])]
    assert not problems, '\n'.join(problems)


def test_bf16_port_keeps_the_f32_labels_and_places(variables, photos,
                                                   port_f32):
    port_bf16 = _port_records(variables, photos, torch.bfloat16)
    stored = golden.load_goldens(os.path.join(HERE, 'data', 'goldens',
                                              MODEL + '.json'))
    problems = []
    for name in photos[1]:
        # the f32 port's detections that the goldens hold, in its order
        expected = port_f32[name][:len(stored['images'][name])]
        assert expected
        problems += ['[{}] {}'.format(name, p) for p in golden.match_records(
            expected, port_bf16[name], score_tol=BF16_SCORE_TOL)]
    assert not problems, '\n'.join(problems)
