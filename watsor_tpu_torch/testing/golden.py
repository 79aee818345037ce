"""The end-to-end golden-accuracy harness (counterpart of
watsor_tpu/testing/golden.py): the bundled natural photographs through the
whole uint8-photo-in -> detections-out path, held to stored goldens by
``match_records`` (the same label, IoU above 0.5, a close score).

The JAX package's goldens (tests/data/goldens/<family>.json) come from its
PRNGKey(0) init, which only JAX can rebuild. The seeded goldens
(tests/data/goldens_seeded/<family>.<mode>.json) come from
``seeded_golden_variables``: a complete flax-layout tree drawn with numpy
alone and saved as ``.msgpack``, which both packages load unchanged, so a
machine without JAX can rebuild it and hold the port to the same records.
One file a family and NMS mode: ``fused`` (the models' default, as the JAX
harness runs) and ``fused_exact`` (the service's default, which runs
kernel 1, ``fixed_point_suppress``).

    python -m watsor_tpu_torch.testing.golden make [family ...]
    python -m watsor_tpu_torch.testing.golden check [family ...]
    python -m watsor_tpu_torch.testing.golden probe family --gains G ...

``make`` writes the seeded goldens on the CPU in f32 (the counterpart of
scripts/make_goldens.py). ``check`` (the counterpart of
scripts/golden_on_tpu.py) runs on the card: each family's f32 detector
with TF32 off at PORT_F32_SCORE_TOL, its production bf16 detector at labels
and places, and its f32 detector with TF32 on, both NMS modes, kernel 1
once a step on each ``fused_exact`` leg; the f32 bar must catch the two
reduced-precision legs. One JSON row a family, and exit 1 on any problem.
``probe`` prints what chose a family's body gain in FAMILY_GAINS.
"""

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

DEFAULT_IMAGES = ('grace_hopper.jpg', 'china.jpg', 'flower.jpg')

# every zoo family with public-checkpoint conversion support
GOLDEN_FAMILIES = (
    'ssd_mobilenet_v1',
    'ssd_mobilenet_v2',
    'ssdlite_mobilenet_v2',
    'ssd_inception_v2',
    'efficientdet_lite0',
    'efficientdet_lite1',
    'efficientdet_lite2',
    'efficientdet_lite3',
    'efficientdet_lite4',
)

# the NMS modes of the seeded goldens: the models' default, and the
# service's default (config/schema.py ``nms: fused_exact``)
GOLDEN_MODES = ('fused', 'fused_exact')

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
IMAGE_DIR = os.path.join(ROOT, 'tests', 'data', 'images')
SEEDED_DIR = os.path.join(ROOT, 'tests', 'data', 'goldens_seeded')

GOLDEN_SEED = 0
STORED_TOP = 8        # records stored a photo
READ_TOP = 20         # detections read a photo when checking, as
                      # tests/test_golden_e2e.py and golden_on_tpu.py read
# the goldens' CI bar (match_records' default), at which the JAX package
# reproduces them on the CPU
F32_SCORE_TOL = 5e-3
# the port's own f32 run with TF32 off, on the CPU that wrote the goldens
# or on the card: no reduced-precision pass, so a record's score moves by
# the order of the sums alone; a TF32 or bf16 pass moves some by more
PORT_F32_SCORE_TOL = 1e-5

# the seeded tree. Kernels are normals of std gain / sqrt(fan-in): the
# family's body gain, or for the predictors its class gain and BOX_GAIN.
# Convolution biases, BatchNorm offsets and means are normals of std
# BIAS_STD; BatchNorm scales and variances, and the BiFPN's fast-attention
# weights, uniform in SCALE_RANGE. The body gains were chosen with
# ``probe`` for two properties at once: each of ``changed_photos`` misses
# records at F32_SCORE_TOL, and bf16 keeps every record's label and place,
# on the CPU and (efficientdet_lite3's, whose records lie closest together)
# on the card. A larger body gain makes the residual families chaotic, where
# bf16's rounding reorders the top detections; a smaller one lets the
# photo's signal fade into the offsets, so that every photo gives the same
# records. family -> (body gain, class gain)
FAMILY_GAINS = {
    'ssd_mobilenet_v1': (1.3, 1.0),
    'ssd_mobilenet_v2': (1.05, 1.0),
    'ssdlite_mobilenet_v2': (1.0, 1.0),
    'ssd_inception_v2': (1.2, 1.0),
    'efficientdet_lite0': (1.0, 0.3),
    'efficientdet_lite1': (1.0, 0.3),
    'efficientdet_lite2': (1.0, 0.3),
    'efficientdet_lite3': (1.04, 0.3),
    'efficientdet_lite4': (1.0, 0.3),
}
BOX_GAIN = 0.1
BIAS_STD = 0.02
SCALE_RANGE = (0.5, 1.5)


def load_photo_batch(image_dir=IMAGE_DIR, names=DEFAULT_IMAGES):
    """Decode the bundled JPEGs into ONE zero-padded uint8 canvas batch,
    each photo top-left on a black canvas the size of the largest, as the
    JAX package's PIL loader lays them out (here ``cv2``, which the port
    already needs; EXIF orientation ignored, as PIL's ``open`` does).
    Returns (batch [B, H, W, 3] uint8 RGB, names)."""
    import cv2

    arrays = []
    for name in names:
        path = os.path.join(image_dir, name)
        bgr = cv2.imread(path, cv2.IMREAD_COLOR |
                         cv2.IMREAD_IGNORE_ORIENTATION)
        if bgr is None:
            raise FileNotFoundError('cannot decode {}'.format(path))
        arrays.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    h = max(a.shape[0] for a in arrays)
    w = max(a.shape[1] for a in arrays)
    batch = np.zeros((len(arrays), h, w, 3), np.uint8)
    for i, a in enumerate(arrays):
        batch[i, :a.shape[0], :a.shape[1]] = a
    return batch, list(names)


def changed_photos(batch):
    """{change: the photo batch changed so that the records should move}:
    10% darker, colour channels swapped, shifted 8 pixels right, mirrored
    (faults of brightness, channel order, placement and layout)."""
    return {'darker': (batch * 0.9).astype(np.uint8),
            'bgr': batch[..., ::-1].copy(),
            'shifted': np.roll(batch, 8, axis=2),
            'mirrored': batch[:, :, ::-1].copy()}


def changed_photo_misses(backend, records, batch, names,
                         score_tol=F32_SCORE_TOL):
    """{change: the number of ``records`` that ``backend`` misses on the
    changed photos (``golden_problems`` at ``score_tol``)}."""
    return {change: len(golden_problems(
        records, run_golden(backend, photos, names, top=READ_TOP), names,
        score_tol)) for change, photos in changed_photos(batch).items()}


def canvas_digest(batch):
    """sha256 of the photo canvas, stored beside the goldens so that a
    machine whose JPEG decoder differs says so."""
    return hashlib.sha256(np.ascontiguousarray(batch).tobytes()).hexdigest()


def build_golden_detector(model_name, model_path=None, nms_mode=None,
                          dtype=torch.float32, device=None):
    """The one way goldens are made and checked: ``build_from_zoo`` (f32
    activations by default, so that near-tie rankings do not move with
    rounding, and the model's default NMS mode) behind the service's
    ``TorchDetectorBackend``, on ``device`` (None: the current CUDA device;
    'cpu' for the CPU). An f32 detector on the card turns TF32 off for the
    process, as the service does for ``TRT_FLOAT_PRECISION=32``
    (main.py ``use_full_f32``)."""
    from watsor_tpu_torch.detection.backend import TorchDetectorBackend
    from watsor_tpu_torch.models.zoo import build_from_zoo

    detector = build_from_zoo(model_name, model_path, dtype=dtype,
                              nms_mode=nms_mode, device=device)
    if dtype == torch.float32 and detector.device.type == 'cuda':
        from watsor_tpu_torch.main import use_full_f32
        use_full_f32()
    return TorchDetectorBackend(detector)


def detections_to_records(boxes, scores, classes, valid, top=8,
                          score_floor=0.0):
    """Per-image list of {label, score, box} for the top-k detections."""
    records = []
    for i in range(boxes.shape[0]):
        n = int(valid[i])
        rows = [r for r in range(n) if scores[i, r] > score_floor]
        rows.sort(key=lambda r: -float(scores[i, r]))
        records.append([
            {'label': int(classes[i, r]),
             'score': round(float(scores[i, r]), 6),
             'box': [round(float(v), 6) for v in boxes[i, r]]}
            for r in rows[:top]])
    return records


def run_golden(backend, batch, names, top=8, score_floor=0.0):
    boxes, scores, classes, valid, _ = backend.detect_batch(batch)[:5]
    records = detections_to_records(boxes, scores, classes, valid,
                                    top=top, score_floor=score_floor)
    return dict(zip(names, records))


def iou(a, b):
    """IoU of two [ymin, xmin, ymax, xmax] boxes."""
    yi0, xi0 = max(a[0], b[0]), max(a[1], b[1])
    yi1, xi1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, yi1 - yi0) * max(0.0, xi1 - xi0)
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def match_records(expected, got, iou_threshold=0.5, score_tol=5e-3):
    """Every expected detection must have a counterpart in ``got`` with the
    same label, IoU above threshold, and a close score. Returns a list of
    human-readable mismatch strings (empty = pass)."""
    problems = []
    for e in expected:
        candidates = [g for g in got if g['label'] == e['label']
                      and iou(e['box'], g['box']) > iou_threshold]
        if not candidates:
            problems.append(
                'no detection matches label={} box={} (have {})'.format(
                    e['label'], e['box'],
                    [(g['label'], [round(v, 3) for v in g['box']])
                     for g in got]))
            continue
        best = min(candidates, key=lambda g: abs(g['score'] - e['score']))
        if score_tol is not None and \
                abs(best['score'] - e['score']) > score_tol:
            problems.append(
                'score drift for label={}: expected {} got {}'.format(
                    e['label'], e['score'], best['score']))
    return problems


def golden_problems(stored_images, got, names, score_tol=F32_SCORE_TOL):
    """``match_records`` over every photo, each problem prefixed with the
    photo's name; a photo whose stored records are empty is a problem."""
    problems = []
    for name in names:
        expected = stored_images[name]
        if not expected:
            problems.append('[{}] the stored golden is empty'.format(name))
        problems += ['[{}] {}'.format(name, p) for p in
                     match_records(expected, got[name], score_tol=score_tol)]
    return problems


def max_score_gap(stored_images, got, names):
    """The largest score difference between a stored record and its
    closest counterpart in ``got`` (the same label, IoU above 0.5), over
    every photo; None where no record has one."""
    gaps = [min(abs(g['score'] - e['score']) for g in got[name]
                if g['label'] == e['label'] and iou(e['box'], g['box']) > 0.5)
            for name in names for e in stored_images[name]
            if any(g['label'] == e['label'] and
                   iou(e['box'], g['box']) > 0.5 for g in got[name])]
    return round(max(gaps), 6) if gaps else None


def load_goldens(path):
    with open(path) as f:
        return json.load(f)


def save_goldens(path, payload):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write('\n')


def seeded_golden_path(family, mode, golden_dir=SEEDED_DIR):
    return os.path.join(golden_dir, '{}.{}.json'.format(family, mode))


def _leaf_rng(seed, collection, path):
    """A numpy stream of its own for one leaf, keyed by the seed and the
    leaf's path, so that adding a leaf never shifts another."""
    key = '/'.join((collection,) + tuple(path)).encode()
    word = int.from_bytes(hashlib.sha256(key).digest()[:8], 'little')
    return np.random.default_rng([seed, word])


def _predictor(path):
    """'box' or 'cls' for the convolution that gives a head's outputs
    (an SSD's ``box_head<i>``/``cls_head<i>``, an EfficientDet's
    ``<head>/predict/pw``), else None."""
    head = path[0].split('_head')[0]
    if head in ('box', 'cls') and (len(path) == 1 or
                                   tuple(path[1:]) == ('predict', 'pw')):
        return head
    return None


def seeded_golden_variables(family, seed=GOLDEN_SEED):
    """The complete flax-layout variables tree of ``family`` (one of
    GOLDEN_FAMILIES: every kernel, bias, BatchNorm scale, offset, mean and
    variance), numpy f32 leaves drawn from ``seed`` alone: HWIO kernels as
    fan-in-scaled normals (FAMILY_GAINS), and biases and BatchNorm
    statistics that are not trivial, so that the folded-BatchNorm and bias
    paths carry signal. The layout is the port's modules' (models/weights.py
    ``leaves``), which is the JAX model's init tree."""
    import torch.nn as nn

    from watsor_tpu_torch.models.efficientdet import (EfficientDet,
                                                      EfficientDetConfig)
    from watsor_tpu_torch.models.ssd import SSD
    from watsor_tpu_torch.models.weights import leaves
    from watsor_tpu_torch.models.zoo import model_config

    config = model_config(family)
    body_gain, cls_gain = FAMILY_GAINS[family]
    with torch.device('meta'):
        model = EfficientDet(config) if isinstance(
            config, EfficientDetConfig) else SSD(config)
    params, stats = {}, {}

    def put(tree, collection, path, draw):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = draw(_leaf_rng(seed, collection, path)) \
            .astype(np.float32)

    def normal(shape, std):
        return lambda rng: rng.standard_normal(shape) * std

    def uniform(shape):
        return lambda rng: rng.uniform(*SCALE_RANGE, size=shape)

    for path, _, leaf in leaves(model):
        if isinstance(leaf, nn.Conv2d):
            out_ch, in_ch, kh, kw = leaf.weight.shape
            gain = {'box': BOX_GAIN, 'cls': cls_gain}.get(_predictor(path),
                                                         body_gain)
            std = gain / (kh * kw * in_ch) ** 0.5
            put(params, 'params', path + ('kernel',),
                normal((kh, kw, in_ch, out_ch), std))
            if leaf.bias is not None:
                put(params, 'params', path + ('bias',),
                    normal((out_ch,), BIAS_STD))
        elif isinstance(leaf, nn.BatchNorm2d):
            n = leaf.num_features
            put(params, 'params', path + ('scale',), uniform((n,)))
            put(params, 'params', path + ('bias',), normal((n,), BIAS_STD))
            put(stats, 'batch_stats', path + ('mean',),
                normal((n,), BIAS_STD))
            put(stats, 'batch_stats', path + ('var',), uniform((n,)))
        else:
            put(params, 'params', path, uniform(tuple(leaf.shape)))
    return {'params': params, 'batch_stats': stats}


def write_seeded_weights(family, model_dir, seed=GOLDEN_SEED):
    """``seeded_golden_variables`` saved as ``<model_dir>/<family>.msgpack``
    by the zoo's ``save_weights`` (flax's bytes); returns the path."""
    from watsor_tpu_torch.models.zoo import save_weights
    return save_weights(seeded_golden_variables(family, seed), model_dir,
                        family)


def distinct_score_problems(images):
    """Each photo must hold STORED_TOP records with pairwise distinct
    scores: a file of ties proves nothing."""
    problems = []
    for name, records in sorted(images.items()):
        scores = [r['score'] for r in records]
        if len(scores) != STORED_TOP or len(set(scores)) != len(scores):
            problems.append('[{}] scores {}'.format(name, scores))
    return problems


def make(families, golden_dir=SEEDED_DIR):
    """Write ``<family>.<mode>.json`` for every family and mode into
    ``golden_dir``: the port's f32 detect step on the CPU over the seeded
    tree's ``.msgpack``, in one torch thread, so that the sums' order, and
    with it the files' bytes, does not depend on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _make(families, golden_dir)
    finally:
        torch.set_num_threads(threads)


def _make(families, golden_dir):
    batch, names = load_photo_batch()
    for family in families:
        with tempfile.TemporaryDirectory() as model_dir:
            write_seeded_weights(family, model_dir)
            for mode in GOLDEN_MODES:
                backend = build_golden_detector(family, model_dir, mode,
                                                device='cpu')
                images = run_golden(backend, batch, names, top=STORED_TOP)
                problems = distinct_score_problems(images)
                if problems:
                    raise ValueError('{} {}: {}'.format(family, mode,
                                                        problems))
                path = seeded_golden_path(family, mode, golden_dir)
                save_goldens(path, {
                    'model': family, 'nms_mode': mode, 'backend': 'cpu',
                    'dtype': 'float32', 'canvas_sha256': canvas_digest(batch),
                    'init': 'watsor_tpu_torch.testing.golden.'
                            'seeded_golden_variables(seed={})'.format(
                                GOLDEN_SEED),
                    'images': images})
                print('wrote', path, flush=True)


def _leg_detector(family, model_dir, dtype, mode, tf32, device):
    """``build_from_zoo`` for one leg under cuDNN's and cuBLAS's TF32
    switches ``tf32`` (a pair); returns (backend, build seconds)."""
    from watsor_tpu_torch.detection.backend import TorchDetectorBackend
    from watsor_tpu_torch.models.zoo import build_from_zoo

    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    start = time.perf_counter()
    detector = build_from_zoo(family, model_dir, dtype=dtype, nms_mode=mode,
                              device=device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return TorchDetectorBackend(detector), time.perf_counter() - start


def check_family(family, batch, names, device):
    """Hold ``family`` on ``device`` to its seeded goldens, each leg built
    once a NMS mode: ``f32`` (TF32 off, PORT_F32_SCORE_TOL) and
    ``bf16_production`` (the zoo's default dtype under the TF32 switches as
    found, labels and places), and on a CUDA device ``f32_tf32`` (f32 with
    TF32 on, labels and places). The reduced-precision legs must each miss
    records at the f32 leg's bar in each mode (``f32_bar_catches``), which
    shows that the bar would catch a pass of theirs.

    Returns the row: the seconds to draw and save the seeded tree; for each
    leg ``ok``, its first problems, build and warm step seconds, the
    largest score gap to the stored records (``max_score_gap``) and kernel
    1's launches a step (1 under ``fused_exact`` on a CUDA device, else 0);
    ``f32_bar_catches``; and ``ok``, all of it. TF32 is left as found."""
    from watsor_tpu_torch.ops.nms_fixed_point import fixed_point_suppress

    device = torch.device(device)
    cuda = device.type == 'cuda'
    stored = {mode: load_goldens(seeded_golden_path(family, mode))['images']
              for mode in GOLDEN_MODES}
    row = {'family': family, 'device': torch.cuda.get_device_name(device)
           if cuda else str(device)}
    found = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    # f32 as TRT_FLOAT_PRECISION=32 serves it; production as users run it
    legs = [('f32', torch.float32, (False, False), PORT_F32_SCORE_TOL),
            ('bf16_production', None, found, None)]
    if cuda:
        legs.append(('f32_tf32', torch.float32, (True, True), None))
    catches = {}
    try:
        with tempfile.TemporaryDirectory() as model_dir:
            start = time.perf_counter()
            write_seeded_weights(family, model_dir)
            row['weights_s'] = round(time.perf_counter() - start, 3)
            for leg, dtype, tf32, score_tol in legs:
                result = {'problems': [], 'build_s': {}, 'step_s': {},
                          'kernel1_launches': {}, 'max_score_gap': {}}
                for mode in GOLDEN_MODES:
                    backend, build_s = _leg_detector(family, model_dir, dtype,
                                                     mode, tf32, device)
                    result['build_s'][mode] = round(build_s, 3)
                    backend.warmup(batch.shape[1:3], batch.shape[0])
                    fixed_point_suppress.launches = 0
                    start = time.perf_counter()
                    got = run_golden(backend, batch, names, top=READ_TOP)
                    result['step_s'][mode] = round(
                        time.perf_counter() - start, 4)
                    launches = fixed_point_suppress.launches
                    result['kernel1_launches'][mode] = launches
                    want = 1 if cuda and mode == 'fused_exact' else 0
                    if launches != want:
                        result['problems'].append(
                            '{}: {} fixed_point_suppress launches a step, {} '
                            'expected'.format(mode, launches, want))
                    result['max_score_gap'][mode] = max_score_gap(
                        stored[mode], got, names)
                    result['problems'] += [
                        '{}: {}'.format(mode, p) for p in golden_problems(
                            stored[mode], got, names, score_tol)]
                    if leg != 'f32':
                        catches.setdefault(leg, {})[mode] = len(
                            golden_problems(stored[mode], got, names,
                                            PORT_F32_SCORE_TOL))
                    del backend
                    if cuda:
                        torch.cuda.empty_cache()
                result['ok'] = not result['problems']
                result['problems'] = result['problems'][:10]
                row[leg] = result
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = found
    row['f32_bar_catches'] = catches
    row['ok'] = all(row[leg]['ok'] for leg, *_ in legs) and all(
        n > 0 for modes in catches.values() for n in modes.values())
    return row


def probe(family, gains, batch, names, device=None):
    """The runs that chose FAMILY_GAINS, on ``device`` (None: the current
    CUDA device, raising without one; 'cpu' for the CPU), as an iterator
    of rows (``_probe_rows``)."""
    from watsor_tpu_torch.models.ssd import resolve_device
    return _probe_rows(family, gains, batch, names, resolve_device(device))


def _probe_rows(family, gains, batch, names, device):
    """For each body gain of ``family``, a seeded tree at that gain (the
    class gain as stored) and its f32 records (TF32 off) under each NMS
    mode on ``device``; yields one row a gain and mode:
    the records each changed photo misses at F32_SCORE_TOL and at labels
    and places (``changed_photo_misses``), the production bf16 run's
    misses at labels and places and its largest score gap, and the photos
    whose records tie in score. ``margin`` is the least score gap, over the
    photos, between the last stored record and the last detection read: a
    record of the f32 run nearer the end of what is read than bf16's
    rounding moves a score drops out of a bf16 run."""
    cls_gain = FAMILY_GAINS[family][1]
    saved = FAMILY_GAINS[family]
    found = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for gain in gains:
            FAMILY_GAINS[family] = (gain, cls_gain)
            with tempfile.TemporaryDirectory() as model_dir:
                write_seeded_weights(family, model_dir)
                for mode in GOLDEN_MODES:
                    f32, _ = _leg_detector(family, model_dir, torch.float32,
                                           mode, (False, False), device)
                    ranked = run_golden(f32, batch, names, top=READ_TOP)
                    records = {name: got[:STORED_TOP]
                               for name, got in ranked.items()}
                    misses = {
                        str(tol): changed_photo_misses(f32, records, batch,
                                                       names, tol)
                        for tol in (F32_SCORE_TOL, None)}
                    bf16, _ = _leg_detector(family, model_dir, None, mode,
                                            found, device)
                    got = run_golden(bf16, batch, names, top=READ_TOP)
                    yield {'family': family, 'gain': gain, 'mode': mode,
                           'margin': round(min(
                               got[STORED_TOP - 1]['score'] -
                               got[-1]['score']
                               for got in ranked.values()), 6),
                           'changed_photo_misses': misses,
                           'bf16_misses': len(golden_problems(
                               records, got, names, None)),
                           'bf16_max_score_gap': max_score_gap(records, got,
                                                               names),
                           'ties': distinct_score_problems(records)}
    finally:
        FAMILY_GAINS[family] = saved
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = found


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m watsor_tpu_torch.testing.golden',
        description='Make the seeded goldens on the CPU, hold a device to '
                    'them, or probe a family\'s body gains.')
    parser.add_argument('command', choices=('make', 'check', 'probe'))
    parser.add_argument('families', nargs='*',
                        help='zoo families (default: all nine)')
    parser.add_argument('--device', default=None,
                        help="check or probe on this device (default: the "
                             "current CUDA device; 'cpu' for the CPU)")
    parser.add_argument('--gains', type=float, nargs='+', default=None,
                        help='probe these body gains (default: the stored '
                             'one)')
    args = parser.parse_args(argv)
    families = args.families or list(GOLDEN_FAMILIES)
    if args.command == 'make':
        make(families)
        return 0
    from watsor_tpu_torch.models.ssd import resolve_device
    device = resolve_device(args.device)
    batch, names = load_photo_batch()
    ok = True
    for family in families:
        if args.command == 'probe':
            for row in probe(family, args.gains or [FAMILY_GAINS[family][0]],
                             batch, names, device):
                print(json.dumps(row), flush=True)
            continue
        row = check_family(family, batch, names, device)
        ok = ok and row['ok']
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
