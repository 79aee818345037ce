"""The port's chained timing harness (watsor_tpu_torch/timing.py) on the
CPU, where a runner loops eagerly: the arithmetic and the data chain of
tests/test_timing.py, ``chained_step_ms``'s record against the JAX
package's on the same clock, the full-path runner's accumulator against
the JAX runner's on the same frames, detector and tables, the production
program's config and tables against the JAX package's, and
``measure_production_device_path``'s record at a tiny size. The CUDA-graph
capture runs only on the card (chip_smoke.py phase 8b)."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import watsor_tpu.timing as jax_timing
from watsor_tpu_torch import timing
from watsor_tpu_torch.config.coco import coco_label_index
from watsor_tpu_torch.ops.filter_device import NUM_LABELS
from watsor_tpu_torch.runtime.frames import MAX_ZONES
from watsor_tpu_torch.timing import (chained_full_path_runner,
                                     chained_model_runner, chained_step_ms)


@pytest.fixture
def one_thread():
    """One torch thread: a team of eight stalls at its barriers when the
    other test workers keep the cores busy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chained_step_ms_scales_with_work(one_thread):
    """A step heavy enough to dominate the loop on the CPU: the per-step
    time comes out positive and the detail record is complete."""
    w = torch.from_numpy(np.random.RandomState(0).randn(512, 512)
                         .astype(np.float32))

    def run(seed, n):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((512, 512), generator=g)
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x.sum()

    ms, detail = chained_step_ms(run, n_short=1, n_long=16, reps=3)
    assert ms > 0
    assert detail['n_short'] == 1 and detail['n_long'] == 16
    assert len(detail['times_short_s']) == 3
    assert len(detail['times_long_s']) == 3
    assert 'compile_s' in detail


class _Clock:
    """A perf_counter that a fake run advances by 3 ms a step plus 40 ms."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def run(self, seed, n):
        self.now += 0.040 + 0.003 * n
        return float(seed)


def test_chained_step_ms_record_equals_the_jax_package(monkeypatch):
    """On the same clock and the same run, the same (ms, detail) as
    watsor_tpu.timing.chained_step_ms, seeds included."""
    records = []
    for module in (timing, jax_timing):
        clock = _Clock()
        seeds = []
        monkeypatch.setattr(module, 'perf_counter', clock)
        records.append((module.chained_step_ms(
            lambda seed, n: seeds.append(seed) or clock.run(seed, n),
            n_short=2, n_long=10, reps=3), seeds))
    assert records[0] == records[1]
    (ms, detail), seeds = records[0]
    assert ms == pytest.approx(3.0)
    assert len(set(seeds)) == len(seeds) == 1 + 2 * 3


def test_chained_model_runner_executes_n_chained_steps():
    """A fake detect_batch whose scores depend only on the input image:
    the carry is zero, so the sum over n steps is n times one step's."""
    batch, size = 2, 8

    def step(params, img):
        s = img.float().mean(dim=(1, 2, 3)) * params
        return None, s[:, None].expand(batch, 4), None, None

    run = chained_model_runner(step, 2.0, batch, size, device='cpu')
    a1 = run(7, 1)
    a5 = run(7, 5)
    assert a1 != 0.0
    assert a5 == pytest.approx(5.0 * a1, rel=1e-6)


def test_chained_model_runner_nonsquare_input():
    batch, hw = 2, (6, 10)
    seen = {}

    def step(params, img):
        seen['shape'] = tuple(img.shape)
        seen['dtype'] = img.dtype
        s = img.float().sum(dim=(1, 2, 3))
        return None, s[:, None].expand(batch, 4), None, None

    run = chained_model_runner(step, 0.0, batch, hw, device='cpu')
    assert np.isfinite(run(3, 2))
    assert seen['shape'] == (batch, 6, 10, 3)
    assert seen['dtype'] == torch.uint8


def test_chained_model_runner_fresh_seed_changes_input():
    batch, size = 2, 8

    def step(params, img):
        s = img.float().sum(dim=(1, 2, 3))
        return None, s[:, None].expand(batch, 4), None, None

    run = chained_model_runner(step, 0.0, batch, size, device='cpu')
    assert run(1, 2) != run(2, 2)
    assert run(1, 2) == run(1, 2)


def test_chained_input_runner_carries_through_one_element():
    """A part's runner writes the carry into its first element alone, in
    one buffer that is not the input ``make_input`` gave: each step sees
    the input's values (the carry is zero) at one address, and the given
    tensor is never written."""
    given = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    want = given.clone()
    seen = []

    def step(x):
        seen.append((x.data_ptr(), x.clone()))
        return x * 2.0, None

    run = timing.chained_input_runner(step, lambda g: given, device='cpu')
    assert run(5, 3) == 3 * 2.0 * float(want[0, 0, 0])
    assert len({ptr for ptr, _ in seen}) == 1
    assert seen[0][0] != given.data_ptr()
    assert all(torch.equal(x, want) for _, x in seen)
    assert torch.equal(given, want)


def test_runner_needs_a_device_or_the_card(monkeypatch):
    """Entry points run on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chained_model_runner(lambda p, x: (None, x), None, 1, 8)


class _Out(NamedTuple):
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


def test_chained_full_path_runner_tiny_shapes():
    """The full-path runner (detect + per-camera filters + pack + overlay
    render, chained) runs on tiny shapes; the accumulator reflects the
    detections the fake step emits, so no stage's result is dropped."""
    batch, hw, n_det = 2, (32, 48), 4

    def detect(params, img):
        # one high-confidence person box a frame, tied to the input pixels
        base = img.float().mean() * 0
        boxes = torch.tensor([[0.1, 0.1, 0.6, 0.6]]).repeat(n_det, 1)
        boxes = boxes[None].repeat(batch, 1, 1) + base
        return _Out(boxes, torch.full((batch, n_det), 0.9),
                    torch.ones((batch, n_det), dtype=torch.int32),
                    torch.full((batch,), n_det, dtype=torch.int32))

    conf = np.full((NUM_LABELS,), np.inf, np.float32)
    conf[coco_label_index('person')] = 0.5
    area = np.zeros((NUM_LABELS,), np.float32)
    zsat = np.zeros((MAX_ZONES, 9, 9), np.float32)     # zones disabled
    zallow = np.zeros((MAX_ZONES, NUM_LABELS), bool)
    tables = tuple(torch.from_numpy(np.stack([t] * 3))
                   for t in (conf, area, zsat, zallow))
    row_idx = np.arange(batch, dtype=np.int32) % 3

    run = chained_full_path_runner(detect, None, tables, row_idx, batch, hw,
                                   device='cpu')
    a2 = run(11, 2)
    a4 = run(11, 4)
    assert np.isfinite(a2) and a2 != 0.0
    # the packed and rendered sums accumulate a step; the carry only flips
    # the frames' parity, so doubling the loop roughly doubles the sum
    assert a4 == pytest.approx(2.0 * a2, rel=0.2)


def test_measure_production_device_path_record():
    """The JAX record's keys, at a tiny size on the CPU: the north-star
    production detector (ssd_mobilenet_v2, fused_exact, person and car)
    behind the demo zones, 2 cameras."""
    record = timing.measure_production_device_path(
        batch=2, hw=(64, 96), n_short=1, n_long=2, reps=1, n_cameras=2,
        device='cpu')
    assert set(record) == {'metric', 'model', 'batch', 'ingest',
                           'ms_per_step', 'fps', 'north_star_fps',
                           'vs_north_star', 'device', 'detail'}
    assert record['model'] == 'ssd_mobilenet_v2 fused_exact C=2'
    assert record['batch'] == 2 and record['ingest'] == '96x64'
    assert record['north_star_fps'] == 960.0
    assert record['device'] == 'cpu'
    assert set(record['detail']) == {'n_short', 'n_long', 'reps',
                                     'compile_s', 'times_short_s',
                                     'times_long_s'}


# the fake detector of the parity tests: six detections a frame, every
# coordinate and score a multiple of 1/8 so that any order of summation
# gives the same f32 sums. Against the demo tables: a person inside the
# first zone (kept), a car across it (kept, but dropped by a camera that
# drops cars), a person on its edge (kept until the carry moves it out), a
# bicycle (not configured), a person below the confidence and a padding slot
_BOXES = np.asarray([[0.125, 0.125, 0.5, 0.5],
                     [0.25, 0.25, 0.75, 0.625],
                     [0.375, 0.375, 0.75, 0.75],
                     [0.125, 0.5, 0.5, 0.875],
                     [0.0, 0.0, 0.5, 0.5],
                     [0.5, 0.125, 0.75, 0.375]], np.float32)
_SCORES = np.asarray([0.875, 0.625, 0.75, 0.75, 0.5, 0.25], np.float32)
_CLASSES = np.asarray([1, 3, 1, 2, 1, 0], np.int32)


def _jax_fake_detect(params, img):
    """The JAX side: one pixel's parity moves every box by 1/8, so the
    carried value reaches the detections and the filters."""
    import jax.numpy as jnp
    batch = img.shape[0]
    shift = (img[:, 0, 0, 0] % 2).astype(jnp.float32) * 0.125
    return _Out(jnp.asarray(_BOXES)[None] + shift[:, None, None],
                jnp.broadcast_to(jnp.asarray(_SCORES), (batch, 6)),
                jnp.broadcast_to(jnp.asarray(_CLASSES), (batch, 6)),
                jnp.full((batch,), 5, jnp.int32))


def _torch_fake_detect(params, img):
    """The same detections as ``_jax_fake_detect``, in torch."""
    batch = img.shape[0]
    shift = (img[:, 0, 0, 0] % 2).float() * 0.125
    return _Out(torch.from_numpy(_BOXES)[None] + shift[:, None, None],
                torch.from_numpy(_SCORES).expand(batch, 6),
                torch.from_numpy(_CLASSES).expand(batch, 6),
                torch.full((batch,), 5, dtype=torch.int32))


@pytest.mark.parametrize('n', [1, 3])
def test_chained_full_path_runner_equals_the_jax_package(monkeypatch, n):
    """The same frames, the same fake detector and the same two cameras'
    tables (the demo tables; the second camera drops cars) through both
    packages' full-path runners: the stage chain (filters, pack, render),
    the carry and the accumulator give the JAX package's sum bit for bit."""
    import jax
    import jax.numpy as jnp

    batch, hw = 2, (16, 24)
    frames = np.random.RandomState(5).randint(
        0, 255, (batch,) + hw + (3,)).astype(np.uint8)
    frames[0, 0, 0, 0] = 0              # the two frames start on both
    frames[1, 0, 0, 0] = 1              # sides of the parity
    monkeypatch.setattr(jax.random, 'randint',
                        lambda *a, **k: jnp.asarray(frames))
    monkeypatch.setattr(torch, 'randint',
                        lambda *a, **k: torch.from_numpy(frames.copy()))

    one = timing.production_tables(hw)
    other = list(one)
    other[0] = one[0].copy()
    other[0][coco_label_index('car')] = np.inf
    tables = [np.stack([a, b]) for a, b in zip(one, other)]
    row_idx = np.asarray([1, 0], np.int32)

    jax_run = jax_timing.chained_full_path_runner(
        _jax_fake_detect, None, tuple(jnp.asarray(t) for t in tables),
        row_idx, batch, hw)
    run = chained_full_path_runner(
        _torch_fake_detect, None, tuple(torch.from_numpy(t) for t in tables),
        row_idx, batch, hw, device='cpu')
    want = float(jax_run(3, n))
    assert want != 0.0
    assert run(3, n) == want


def test_measure_production_device_path_builds_the_jax_program(monkeypatch):
    """Both packages' ``measure_production_device_path`` at 1920x1080 for
    32 cameras, with the detector's build and the timing replaced by
    recorders: the same detector config, the same tables bit for bit (the
    two-zone mask and the demo detect config), the same camera rows, and
    the same record from the same measured time."""
    import watsor_tpu.models.ssd as jax_ssd
    import watsor_tpu_torch.models.ssd as torch_ssd

    class _Detector:
        params = None
        detect_batch = None

    seen = []
    for module, ssd in ((jax_timing, jax_ssd), (timing, torch_ssd)):
        got = {}
        monkeypatch.setattr(
            ssd, 'build_detector',
            lambda cfg, **kw: got.update(cfg=cfg) or _Detector())
        monkeypatch.setattr(
            module, 'chained_full_path_runner',
            lambda detect, params, tables, row_idx, batch, hw, **kw:
            got.update(tables=[np.asarray(t) for t in tables],
                       row_idx=np.asarray(row_idx), batch=batch, hw=hw))
        monkeypatch.setattr(module, 'chained_step_ms',
                            lambda run, **kw: (18.5, {'n_long': 32}))
        kwargs = {'device': 'cpu'} if module is timing else {}
        record = module.measure_production_device_path(batch=32, **kwargs)
        record.pop('device')
        got['record'] = record
        seen.append(got)

    jax_got, got = seen
    mine, theirs = got['cfg']._asdict(), jax_got['cfg']._asdict()
    assert str(mine.pop('dtype')).endswith('bfloat16')
    assert theirs.pop('dtype').__name__ == 'bfloat16'
    assert mine == theirs
    assert got['cfg'].nms_mode == 'fused_exact'
    assert got['cfg'].active_labels == (1, 3)
    assert len(got['tables']) == len(jax_got['tables']) == 4
    for mine, theirs in zip(got['tables'], jax_got['tables']):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert mine.shape[0] == 32
        np.testing.assert_array_equal(mine, theirs)
    # both zones are drawn: the SATs of the first two zones are not empty
    assert got['tables'][2][0, :2, -1, -1].min() > 0
    np.testing.assert_array_equal(got['row_idx'], jax_got['row_idx'])
    assert (got['batch'], tuple(got['hw'])) == \
        (jax_got['batch'], tuple(jax_got['hw'])) == (32, (1080, 1920))
    assert got['record'] == jax_got['record']
