"""The seeded photo goldens (tests/data/goldens_seeded/<family>.<mode>.json)
and the port's harness that makes and checks them
(watsor_tpu_torch/testing/golden.py), on the CPU:

- the port's cv2 photo canvas equals the JAX package's PIL canvas byte
  for byte (the stored files carry its sha256);
- ``seeded_golden_variables`` is deterministic, draws each leaf from a
  stream of its own, is not trivial, and has exactly the paths and shapes
  of the JAX model's init tree for all nine families (``jax.eval_shape``:
  no init is run);
- the port's f32 detect step on the tree's ``.msgpack`` reproduces the
  stored records at the CI bar (``match_records``, score within 5e-3), and
  so does the JAX package's own harness on the same file
  (``build_golden_detector`` for the models' default ``fused``, a
  ``JaxDetectorBackend`` over ``build_from_zoo(nms_mode='fused_exact')``
  for the service's default). ``ssd_mobilenet_v2`` and
  ``efficientdet_lite0`` run in tier 1, as scripts/golden_on_tpu.py
  defaults to them; the other seven are ``slow``, as
  tests/test_golden_e2e.py is.

The f32 reproduction holds each photo's top 8 stored records against the
top 20 detections of the run (READ_TOP), as tests/test_golden_e2e.py does.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from watsor_tpu.detection.backend import JaxDetectorBackend
from watsor_tpu.models.efficientdet import EfficientDet as JaxEfficientDet
from watsor_tpu.models.efficientdet import lite_config as jax_lite_config
from watsor_tpu.models.ssd import SSD as JaxSSD
from watsor_tpu.models.zoo import MODEL_REGISTRY as JAX_REGISTRY
from watsor_tpu.models.zoo import build_from_zoo as jax_build_from_zoo
from watsor_tpu.testing import golden as jax_golden
from watsor_tpu_torch.models.msgpack import load_msgpack
from watsor_tpu_torch.testing import golden
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

TIER1 = ('ssd_mobilenet_v2', 'efficientdet_lite0')
CASES = [pytest.param(family, mode, marks=() if family in TIER1
                      else pytest.mark.slow)
         for family in golden.GOLDEN_FAMILIES for mode in golden.GOLDEN_MODES]


@pytest.fixture(scope='module')
def photos():
    return golden.load_photo_batch()


@pytest.fixture(scope='module')
def model_dirs(tmp_path_factory):
    """family -> a directory holding its seeded ``.msgpack``, written once
    a module."""
    written = {}

    def model_dir(family):
        if family not in written:
            path = tmp_path_factory.mktemp(family)
            golden.write_seeded_weights(family, str(path))
            written[family] = str(path)
        return written[family]
    return model_dir


def _stored(family, mode):
    stored = golden.load_goldens(golden.seeded_golden_path(family, mode))
    assert (stored['model'], stored['nms_mode'], stored['backend'],
            stored['dtype']) == (family, mode, 'cpu', 'float32')
    return stored


def test_cv2_canvas_equals_the_jax_pil_canvas(photos):
    batch, names = photos
    want, want_names = jax_golden.load_photo_batch(golden.IMAGE_DIR)
    assert names == want_names == list(golden.DEFAULT_IMAGES)
    assert batch.dtype == want.dtype == np.uint8
    assert batch.shape == want.shape == (3, 600, 640, 3)
    np.testing.assert_array_equal(batch, want)
    digest = golden.canvas_digest(batch)
    for family in golden.GOLDEN_FAMILIES:
        for mode in golden.GOLDEN_MODES:
            assert _stored(family, mode)['canvas_sha256'] == digest


def test_the_harness_keeps_the_jax_package_names():
    """Every public name of the JAX harness, and the seeded tree."""
    public = {name for name in vars(jax_golden) if not name.startswith('_')
              and name not in ('json', 'os', 'np')}
    assert public <= set(vars(golden))
    assert golden.GOLDEN_FAMILIES == jax_golden.GOLDEN_FAMILIES
    assert golden.DEFAULT_IMAGES == jax_golden.DEFAULT_IMAGES
    assert callable(golden.seeded_golden_variables)


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _jax_init_shapes(family):
    """{path: shape} of the JAX zoo model's init tree, traced by
    ``jax.eval_shape`` (no init is run)."""
    if family.startswith('efficientdet_'):
        cfg = jax_lite_config(family.split('_', 1)[1], dtype=jnp.float32)
        model = JaxEfficientDet(cfg)
    else:
        cfg = JAX_REGISTRY[family][1]._replace(dtype=jnp.float32)
        model = JaxSSD(cfg)
    dummy = jax.ShapeDtypeStruct((1, cfg.input_size, cfg.input_size, 3),
                                 jnp.float32)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), dummy)
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(key.key for key in path): tuple(leaf.shape)
            for path, leaf in leaves}


@pytest.mark.parametrize('family', golden.GOLDEN_FAMILIES)
def test_seeded_tree_has_the_jax_init_layout(family):
    tree = golden.seeded_golden_variables(family)
    got = {path: leaf.shape for path, leaf in _flat(tree)}
    assert got == _jax_init_shapes(family)
    assert all(leaf.dtype == np.float32 for _, leaf in _flat(tree))
    again = golden.seeded_golden_variables(family)
    for path, leaf in _flat(tree):
        np.testing.assert_array_equal(leaf, dict(_flat(again))[path])


def test_seeded_tree_is_not_trivial_and_keyed_by_path():
    """Biases, BatchNorm offsets, means and variances are drawn (not the
    init's zeros and ones); another seed moves every leaf; a leaf's values
    depend on its path alone, so two families that share a BatchNorm's
    path share its draws (adding a leaf never shifts another)."""
    v2 = dict(_flat(golden.seeded_golden_variables('ssd_mobilenet_v2')))
    lite = dict(_flat(golden.seeded_golden_variables('ssdlite_mobilenet_v2')))
    other = dict(_flat(golden.seeded_golden_variables('ssd_mobilenet_v2', 1)))
    for path, leaf in v2.items():
        if path[-1] in ('bias', 'mean'):
            assert np.abs(leaf).min() > 0 and leaf.std() > 0, path
        if path[-1] in ('scale', 'var'):
            assert leaf.min() >= 0.5 and leaf.max() <= 1.5 and \
                leaf.std() > 0, path
        assert not np.array_equal(leaf, other[path]), path
    bn = [p for p in v2 if p[-1] in ('scale', 'mean', 'var') and p in lite]
    assert len(bn) > 100
    for path in bn:
        np.testing.assert_array_equal(v2[path], lite[path])
    # a kernel is a fan-in-scaled normal: std about gain / sqrt(fan-in)
    kernel = v2[('params', 'backbone', 'block5', 'expand', 'Conv_0',
                 'kernel')]
    gain = golden.FAMILY_GAINS['ssd_mobilenet_v2'][0]
    assert abs(kernel.std() * np.sqrt(np.prod(kernel.shape[:3])) / gain
               - 1.0) < 0.05


def test_seeded_msgpack_reads_back_bit_for_bit(model_dirs):
    family = 'efficientdet_lite0'
    path = os.path.join(model_dirs(family), family + '.msgpack')
    got = dict(_flat(load_msgpack(path)))
    want = dict(_flat(golden.seeded_golden_variables(family)))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], leaf)


@pytest.mark.parametrize('family', golden.GOLDEN_FAMILIES)
def test_stored_records_are_distinct(family):
    """Each photo holds 8 records, none tied in score: a file of ties
    proves nothing."""
    for mode in golden.GOLDEN_MODES:
        images = _stored(family, mode)['images']
        assert sorted(images) == sorted(golden.DEFAULT_IMAGES)
        assert not golden.distinct_score_problems(images)


@pytest.mark.parametrize('family,mode', CASES)
def test_port_f32_reproduces_the_seeded_goldens(family, mode, photos,
                                                model_dirs):
    batch, names = photos
    backend = golden.build_golden_detector(family, model_dirs(family), mode,
                                           device='cpu')
    assert backend._detector.config.nms_mode == mode
    got = golden.run_golden(backend, batch, names, top=golden.READ_TOP)
    problems = golden.golden_problems(_stored(family, mode)['images'], got,
                                      names, golden.PORT_F32_SCORE_TOL)
    assert not problems, '\n'.join(problems)


@pytest.mark.parametrize('family,mode', CASES)
def test_jax_package_reproduces_the_seeded_goldens(family, mode,
                                                   model_dirs):
    """The JAX package's own harness on the same ``.msgpack``: its PIL
    canvas, its f32 ``build_from_zoo`` (the weights decide the geometry)
    behind ``JaxDetectorBackend``, its ``run_golden`` and
    ``match_records``."""
    batch, names = jax_golden.load_photo_batch(golden.IMAGE_DIR)
    model_dir = model_dirs(family)
    if mode == 'fused':
        backend = jax_golden.build_golden_detector(family, model_dir)
    else:
        backend = JaxDetectorBackend(jax_build_from_zoo(
            family, model_dir, dtype=jnp.float32, nms_mode=mode))
    assert backend._detector.config.nms_mode == mode
    got = jax_golden.run_golden(backend, batch, names, top=golden.READ_TOP)
    stored = _stored(family, mode)['images']
    problems = []
    for name in names:
        problems += ['[{}] {}'.format(name, p) for p in
                     jax_golden.match_records(stored[name], got[name],
                                              score_tol=golden.F32_SCORE_TOL)]
    assert not problems, '\n'.join(problems)


@pytest.mark.parametrize('family,mode', CASES)
def test_goldens_see_the_photos(family, mode, photos, model_dirs):
    """The seeded tree carries the photos to the records: each changed
    photo (``golden.changed_photos``: darker, channels swapped, shifted,
    mirrored) misses stored records at the goldens' CI bar, so a fault of
    brightness, channel order, placement or layout in the resize or the
    normalization cannot pass them."""
    batch, names = photos
    backend = golden.build_golden_detector(family, model_dirs(family), mode,
                                           device='cpu')
    missed = golden.changed_photo_misses(backend, _stored(family, mode)[
        'images'], batch, names, golden.F32_SCORE_TOL)
    assert set(missed) == {'darker', 'bgr', 'shifted', 'mirrored'}
    assert all(n > 0 for n in missed.values()), missed


def test_probe_reports_the_stored_gain_and_restores_it(photos):
    """``probe`` (what chose FAMILY_GAINS) at a family's stored gain
    gives records that keep their labels and places in bf16 and that each
    changed photo moves; FAMILY_GAINS is left as it was, and another gain
    gives another tree."""
    batch, names = photos
    family = 'efficientdet_lite0'
    gain = golden.FAMILY_GAINS[family]
    rows = list(golden.probe(family, [gain[0]], batch, names, 'cpu'))
    assert [row['mode'] for row in rows] == list(golden.GOLDEN_MODES)
    for row in rows:
        assert row['gain'] == gain[0] and not row['ties']
        assert row['bf16_misses'] == 0, row
        assert all(n > 0 for n in
                   row['changed_photo_misses'][str(golden.F32_SCORE_TOL)]
                   .values()), row
    assert golden.FAMILY_GAINS[family] == gain
    stem = ('params', 'backbone', 'stem', 'Conv_0', 'kernel')
    kernel = dict(_flat(golden.seeded_golden_variables(family)))[stem]
    golden.FAMILY_GAINS[family] = (2 * gain[0], gain[1])
    try:
        other = dict(_flat(golden.seeded_golden_variables(family)))[stem]
    finally:
        golden.FAMILY_GAINS[family] = gain
    np.testing.assert_allclose(other, 2 * kernel, rtol=1e-6)


def test_probe_runs_on_the_card_unless_asked_for_the_cpu(photos,
                                                       monkeypatch):
    """``probe`` with no device takes the current CUDA device, as the
    port's entry points do: with none visible it raises at the call, and
    never falls back to the CPU."""
    batch, names = photos
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        golden.probe('efficientdet_lite0', [1.0], batch, names)


def test_check_holds_the_cpu_to_the_goldens(photos):
    """``check_family`` on the CPU: the f32 leg at the port's bar, the bf16
    leg at labels and places, and the f32 bar catching the bf16 leg in both
    modes; no kernel launches (the CPU takes the plain versions), no TF32
    leg off the card, TF32 left as it was."""
    batch, names = photos
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    row = golden.check_family('efficientdet_lite0', batch, names, 'cpu')
    assert row['family'] == 'efficientdet_lite0' and row['device'] == 'cpu'
    assert row['ok'] and 'f32_tf32' not in row
    for leg in ('f32', 'bf16_production'):
        assert row[leg]['ok'], row[leg]['problems']
        assert row[leg]['kernel1_launches'] == {'fused': 0, 'fused_exact': 0}
        assert set(row[leg]['step_s']) == set(golden.GOLDEN_MODES)
        assert set(row[leg]['build_s']) == set(golden.GOLDEN_MODES)
    assert max(row['f32']['max_score_gap'].values()) <= \
        golden.PORT_F32_SCORE_TOL
    catches = row['f32_bar_catches']
    assert set(catches) == {'bf16_production'}
    assert all(n > 0 for n in catches['bf16_production'].values()), catches
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == tf32


def test_make_rewrites_the_stored_file_byte_for_byte(tmp_path):
    """``make`` is the one path that writes the goldens: run again, it
    gives the committed bytes (indent 1, sorted keys, a trailing
    newline)."""
    family = 'ssd_mobilenet_v2'
    golden.make([family], golden_dir=str(tmp_path))
    for mode in golden.GOLDEN_MODES:
        with open(golden.seeded_golden_path(family, mode), 'rb') as f:
            want = f.read()
        with open(golden.seeded_golden_path(family, mode, str(tmp_path)),
                  'rb') as f:
            assert f.read() == want
