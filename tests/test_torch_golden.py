"""The port's detect step on the bundled photographs, held to the stored
photo goldens (tests/data/goldens/<family>.json): ssd_mobilenet_v2 in f32
and bf16, and the other SSD families of ``golden.GOLDEN_FAMILIES`` in f32
(the EfficientDets are in tests/test_torch_golden_effdet.py).

The goldens were made on the CPU in f32 from the JAX package's PRNGKey(0)
weights (watsor_tpu/testing/golden.py ``build_golden_detector``). The same
tree is carried across with the port's weight bridge, and the port's f32
``detect_batch`` runs the photographs that tests/test_golden_e2e.py runs,
at full width (300x300, 90 classes, ``nms: fused_exact``):

- f32 against the goldens with ``golden.match_records``: the same label,
  IoU above 0.5, and the score within 5e-3;
- bf16 against the port's own f32 result: the same labels in the same
  places, the score within BF16_SCORE_TOL.

The other families follow watsor_tpu/testing/golden.py
``build_golden_detector`` in full: f32 and the model's default NMS mode.
JAX only builds the weight tree (``golden_tree``: ``build_from_zoo``'s
PRNGKey(0) init, compiled as one program, which gives the same tree); its
detector does not run. The photographs are loaded, and the records made and
matched, by the port's own harness (watsor_tpu_torch/testing/golden.py),
whose cv2 canvas tests/test_torch_golden_seeded.py holds to the JAX
package's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.models.efficientdet import EfficientDet as JaxEfficientDet
from watsor_tpu.models.efficientdet import lite_config as jax_lite_config
from watsor_tpu.models.ssd import SSD as JaxSSD
from watsor_tpu.models.zoo import MODEL_REGISTRY as JAX_REGISTRY
from watsor_tpu_torch.testing import golden
from watsor_tpu_torch.models.efficientdet import build_effdet
from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
from watsor_tpu_torch.models.zoo import model_config

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
    return golden_tree(MODEL)


def golden_tree(family):
    """The JAX zoo's f32 PRNGKey(0) variables tree of ``family``, numpy
    leaves: ``build_from_zoo``'s ``model.init``, as one compiled program."""
    if family.startswith('efficientdet_'):
        cfg = jax_lite_config(family.split('_', 1)[1], dtype=jnp.float32)
        model = JaxEfficientDet(cfg)
    else:
        cfg = JAX_REGISTRY[family][1]._replace(dtype=jnp.float32)
        model = JaxSSD(cfg)
    dummy = jnp.zeros((1, cfg.input_size, cfg.input_size, 3), jnp.float32)
    tree = jax.jit(model.init)(jax.random.PRNGKey(0), dummy)
    return jax.tree_util.tree_map(np.asarray, tree)


def _stored(family):
    stored = golden.load_goldens(os.path.join(HERE, 'data', 'goldens',
                                              family + '.json'))
    assert stored['backend'] == 'cpu' and stored['dtype'] == 'float32'
    return stored['images']


def golden_problems(family, records, names):
    """The port's records of ``family`` against its stored goldens, as
    match_records lists the mismatches."""
    return golden.golden_problems(_stored(family), records, names)


@pytest.fixture(scope='module')
def photos():
    return golden.load_photo_batch(IMAGE_DIR)


def port_records(variables, photos, dtype, family=MODEL):
    """The port's detect step of ``family`` (its default NMS mode) on the
    photographs, as golden records by photo."""
    batch, names = photos
    cfg = model_config(family)._replace(dtype=dtype)
    build = build_detector if isinstance(cfg, SSDConfig) else build_effdet
    detector = build(cfg, variables=variables, device='cpu')
    with torch.inference_mode():
        out = detector.detect_batch(torch.from_numpy(batch))
    records = golden.detections_to_records(
        *(t.numpy() for t in (out.boxes, out.scores, out.classes,
                              out.valid)), top=TOP)
    return dict(zip(names, records))


@pytest.fixture(scope='module')
def port_f32(variables, photos):
    return port_records(variables, photos, torch.float32)


def test_f32_port_matches_the_stored_goldens(port_f32, photos):
    problems = golden_problems(MODEL, port_f32, photos[1])
    assert not problems, '\n'.join(problems)


def test_bf16_port_keeps_the_f32_labels_and_places(variables, photos,
                                                   port_f32):
    port_bf16 = port_records(variables, photos, torch.bfloat16)
    stored = _stored(MODEL)
    problems = []
    for name in photos[1]:
        # the f32 port's detections that the goldens hold, in its order
        expected = port_f32[name][:len(stored[name])]
        assert expected
        problems += ['[{}] {}'.format(name, p) for p in golden.match_records(
            expected, port_bf16[name], score_tol=BF16_SCORE_TOL)]
    assert not problems, '\n'.join(problems)


@pytest.mark.parametrize('family', [f for f in golden.GOLDEN_FAMILIES
                                    if f.startswith('ssd')
                                    and f != MODEL])
def test_f32_family_matches_the_stored_goldens(family, photos):
    records = port_records(golden_tree(family), photos, torch.float32,
                           family)
    problems = golden_problems(family, records, photos[1])
    assert not problems, '\n'.join(problems)
