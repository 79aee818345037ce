"""The port's measurement entry points (watsor_tpu_torch/bench.py) on the
CPU against the scripts they port: bench.py (``step``),
scripts/run_baseline5.py (``app``) and scripts/latency_sweep.py
(``sweep``).

bench.py's record keys are read with ``ast`` from its source: running it
builds and compiles the JAX detector, longer than this file may take. The
two scripts are imported by path (their top level reads only the
environment), and their configuration texts, ``aggregate`` and ``sample``
are held to the port's. The application runs here at the size of
testing/fleet_app.py: a tiny SSD, cameras of 96x64, the CPU pool. The
chained harness's loop lengths are cut in the ``step`` runs; its arithmetic
is tests/test_torch_timing.py's. On the card ``chip_smoke.py`` phase 10
runs the subcommands at full size."""

import ast
import importlib.util
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from watsor_tpu_torch import bench, timing
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ('WATSOR_FUSED_BLOCKS', 'WATSOR_QUANTIZE', 'WATSOR_INT8_POINTWISE',
         'WATSOR_FLEET', 'WATSOR_DEVICE_RENDER', 'WATSOR_DEVICE_POOL',
         'WATSOR_MIN_BUCKET', 'WATSOR_MODEL', 'TRT_FLOAT_PRECISION',
         'BASELINE5_OUT', 'SWEEP_OUT')


@pytest.fixture
def clean_env(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


def _free_port():
    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _script(name, monkeypatch, **env):
    """scripts/<name>.py imported by path under ``env``."""
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))
    spec = importlib.util.spec_from_file_location(
        '_script_' + name, os.path.join(ROOT, 'scripts', name + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dict_keys(node):
    return {k.value for k in node.keys}


def _bench_py_keys():
    """From bench.py's ``main``: the keys of the ``result`` literal, of its
    ``spread`` and its recorded ``device_path``, the ``result[...] =``
    assignments, the roofline keys it copies in a loop, and the keys of its
    error record."""
    tree = ast.parse(open(os.path.join(ROOT, 'bench.py')).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == 'main')
    keys = {'assigned': set()}
    for node in ast.walk(main):
        if isinstance(node, ast.Dict) and 'error' in _dict_keys(node):
            keys['error'] = _dict_keys(node)
        elif isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            keys['roofline'] = {e.value for e in node.iter.elts}
        elif isinstance(node, ast.Assign):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == 'result':
                keys['result'] = _dict_keys(node.value)
                names = [k.value for k in node.value.keys]
                keys['spread'] = _dict_keys(
                    node.value.values[names.index('spread')])
            elif isinstance(target, ast.Subscript) and \
                    isinstance(target.value, ast.Name) and \
                    target.value.id == 'result' and \
                    isinstance(target.slice, ast.Constant):
                keys['assigned'].add(target.slice.value)
                if isinstance(node.value, ast.Dict):
                    keys['device_path'] = _dict_keys(node.value)
    return keys


def _renamed(keys):
    return {'e2e_h2d_fps' if k == 'e2e_tunnel_fps' else k for k in keys}


def _short_chains(monkeypatch):
    real = timing.chained_step_ms
    monkeypatch.setattr(timing, 'chained_step_ms', lambda run, **kw: real(
        run, n_short=1, n_long=2, reps=1, log=kw.get('log')))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_step_prints_bench_py_keys(clean_env, capsys):
    """``step --device cpu`` at batch 2 prints one JSON line with bench.py's
    keys: ``e2e_h2d_fps`` for ``e2e_tunnel_fps``, ``device_path`` measured
    in the run, the chained keys, and the roofline keys the CPU's row has
    (no peaks)."""
    for key, value in (('BENCH_BATCH', 2), ('BENCH_STEPS', 2),
                       ('BENCH_REPS', 1)):
        clean_env.setenv(key, str(value))
    _short_chains(clean_env)
    assert bench.main(['step', '--device', 'cpu']) == 0
    record = _last_json(capsys)
    want = _bench_py_keys()
    expected = _renamed(want['result']) | {'device_path',
                                           'chained_ms_per_step',
                                           'chained_fps'}
    assert expected <= _renamed(want['result']) | want['assigned']
    roofline = set(record) & want['roofline']
    assert set(record) - roofline == expected
    assert {'gflops_per_frame', 'hbm_mb_per_frame',
            'arithmetic_intensity'} <= roofline
    assert set(record['spread']) == _renamed(want['spread'])
    assert set(record['device_path']) == want['device_path']
    assert record['device_path']['source'] == 'measured this run'
    assert record['device_path']['batch'] == 2
    assert record['device_path']['fps'] > 0
    assert record['value'] > 0 and record['e2e_h2d_fps'] > 0
    assert record['e2e_pipelined_fps'] > 0 and record['chained_fps'] > 0
    assert record['device'] == 'cpu'
    assert record['spread']['value']['n'] == 1


def _step_fails_with(monkeypatch, capsys, name):
    """``step`` with timing.``name`` raising: exit 1 and the error
    record."""
    for key, value in (('BENCH_BATCH', 1), ('BENCH_STEPS', 1),
                       ('BENCH_REPS', 1)):
        monkeypatch.setenv(key, str(value))
    _short_chains(monkeypatch)

    def broken(*args, **kwargs):
        raise RuntimeError('capture failed')

    monkeypatch.setattr(timing, name, broken)
    assert bench.main(['step', '--device', 'cpu']) == 1
    record = _last_json(capsys)
    assert set(record) == _bench_py_keys()['error']
    assert record['value'] == 0 and 'capture failed' in record['error']


def test_a_failed_device_path_fails_the_step(clean_env, capsys):
    """bench.py keeps its record when a cross-check fails; the port fails
    the run and prints the error record."""
    _step_fails_with(clean_env, capsys, 'measure_production_device_path')


def test_a_failed_chained_leg_fails_the_step(clean_env, capsys):
    """The same for the chained cross-check (bench.py:189-191 logs it and
    goes on)."""
    _step_fails_with(clean_env, capsys, 'chained_model_runner')


@pytest.mark.parametrize('command', ['step', 'app', 'sweep'])
def test_without_a_card_each_subcommand_exits_1(clean_env, capsys, command):
    """No card and no ``--device``: bench.py's error record, exit 1, and
    nothing runs on the CPU."""
    clean_env.setattr(torch.cuda, 'is_available', lambda: False)
    clean_env.setattr(bench, 'run_' + command, None)
    assert bench.main([command]) == 1
    record = _last_json(capsys)
    assert set(record) == _bench_py_keys()['error']
    assert record['value'] == 0 and record['vs_baseline'] == 0
    assert 'no CUDA device' in record['error']


def test_the_module_refuses_to_run_without_a_card():
    """``python -m watsor_tpu_torch.bench step`` with no card visible: exit
    1 and the error record as its one line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-m', 'watsor_tpu_torch.bench',
                           'step'], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 1, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    assert set(json.loads(lines[0])) == _bench_py_keys()['error']


def test_nms_applies_to_app_only(capsys):
    with pytest.raises(SystemExit):
        bench.main(['step', '--device', 'cpu', '--nms', 'exact'])


def test_app_config_and_mask_equal_run_baseline5(monkeypatch, tmp_path):
    script = _script('run_baseline5', monkeypatch, BASELINE5_CAMERAS=3,
                     BASELINE5_PORT=12345)
    script.make_config(str(tmp_path / 'jax.yaml'), '/masks/m.png')
    bench.make_config(str(tmp_path / 'port.yaml'), '/masks/m.png', 3, 12345)
    jax_text = (tmp_path / 'jax.yaml').read_text()
    assert (tmp_path / 'port.yaml').read_text() == jax_text
    # --nms writes the top-level key, nothing else
    bench.make_config(str(tmp_path / 'nms.yaml'), '/masks/m.png', 3, 12345,
                      nms='exact')
    assert (tmp_path / 'nms.yaml').read_text() == jax_text.replace(
        'cameras:\n', 'nms: exact\ncameras:\n', 1)
    script.make_mask(str(tmp_path / 'jax.png'))
    bench.make_mask(str(tmp_path / 'port.png'))
    assert (tmp_path / 'port.png').read_bytes() == \
        (tmp_path / 'jax.png').read_bytes()


def test_sweep_config_equals_latency_sweep(monkeypatch, tmp_path):
    script = _script('latency_sweep', monkeypatch, SWEEP_CAMERAS=3,
                     SWEEP_WIDTH=640, SWEEP_HEIGHT=480, SWEEP_PORT=23456)
    script.make_config(str(tmp_path / 'jax.yaml'))
    bench.make_sweep_config(str(tmp_path / 'port.yaml'), 3, 23456, 640, 480)
    assert (tmp_path / 'port.yaml').read_text() == \
        (tmp_path / 'jax.yaml').read_text()


METRICS = {
    'cameras': [
        {'name': 'cam00', 'fps': {'decoder': 29.5, 'sieve': 29.1,
                                  'visual_effects': 29.0, 'snapshot': 28.7,
                                  'encoder': 27.3},
         'buffer_in': 40, 'buffer_out': 10, 'latency_ms_p50': 41.2,
         'latency_ms': {'sieve': {'p50': 41.2, 'p95': 77.9},
                        'encoder': {'p50': 12.0, 'p95': 20.5}}},
        {'name': 'cam01', 'fps': {'decoder': 30.1, 'sieve': 28.4,
                                  'visual_effects': 28.4, 'snapshot': 28.0},
         'buffer_in': 67, 'buffer_out': 0, 'latency_ms_p50': 55.0,
         'latency_ms': {'sieve': {'p50': 55.0, 'p95': 91.3}}},
        {'name': 'cam02', 'fps': {'decoder': 0.0, 'sieve': 0.0,
                                  'visual_effects': 0.0, 'snapshot': 0.0},
         'buffer_in': 0, 'buffer_out': 0, 'latency_ms_p50': 0.0,
         'latency_ms': {'sieve': {'p50': 0.0, 'p95': 0.0}}}],
    'detectors': [{'name': 'CUDA 0', 'fps': 59.6, 'fps_max': 312.0,
                   'inference_time': 3.2, 'latency_ms_p50': 33.4,
                   'latency_ms_p95': 61.0}]}


def test_aggregate_and_sample_equal_the_scripts(monkeypatch):
    baseline5 = _script('run_baseline5', monkeypatch)
    sweep = _script('latency_sweep', monkeypatch)
    assert bench.aggregate(METRICS) == baseline5.aggregate(METRICS)
    assert bench.sample(METRICS) == sweep.sample(METRICS)


def _script_record_keys(name, variable):
    """The keys of the dict literal that ``main`` of scripts/<name>.py
    assigns to ``variable``."""
    tree = ast.parse(open(os.path.join(ROOT, 'scripts', name + '.py')).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == variable and \
                isinstance(node.value, ast.Dict):
            return _dict_keys(node.value)
    raise AssertionError('{} has no {} literal'.format(name, variable))


@pytest.fixture
def tiny_model(clean_env):
    from watsor_tpu_torch.models import zoo
    from watsor_tpu_torch.testing.fleet_app import tiny_ssd_config
    clean_env.setitem(zoo.MODEL_REGISTRY, 'ssd_tiny_test', tiny_ssd_config())
    clean_env.setattr(bench, 'SAMPLE_PERIOD_S', 2.0)
    return clean_env


def test_app_runs_on_the_cpu(tiny_model):
    """A short ``app`` run at fleet_app's size (4 cameras of 96x64, the
    tiny SSD, the CPU pool): run_baseline5.py's keys (with ``path`` and
    ``notes``), detector frames/s above 0 and p50 <= p95."""
    for key, value in (('BASELINE5_CAMERAS', 4), ('BASELINE5_DURATION', 4),
                       ('BASELINE5_PORT', _free_port()),
                       ('BASELINE5_WARM_DEADLINE', 120),
                       ('WATSOR_MODEL', 'ssd_tiny_test')):
        tiny_model.setenv(key, str(value))
    record = bench.run_app(torch.device('cpu'), frame_hw=(64, 96))
    assert set(record) == _script_record_keys('run_baseline5', 'result') | \
        {'path', 'notes'}
    assert record['cameras'] == 4 and len(record['samples']) >= 1
    assert record['detector_fps'] > 0
    assert 0 < record['latency_ms_p50'] <= record['latency_ms_p95']
    assert record['decoder_fps_total'] > 0
    assert record['environment']['device'] == 'cpu'
    assert record['path'] == {'WATSOR_FUSED_BLOCKS': None,
                              'WATSOR_QUANTIZE': None,
                              'WATSOR_INT8_POINTWISE': None, 'nms': None}
    assert 'WATSOR_DEVICE_POOL' not in os.environ
    assert 'WATSOR_DEVICE_RENDER' not in os.environ


def test_sweep_runs_on_the_cpu(tiny_model, tmp_path):
    """A short ``sweep`` run at the same size: latency_sweep.py's keys with
    ``link`` for ``tunnel`` (none on the CPU) and the device; the bucket
    pinned for the run only; the line appended to SWEEP_OUT."""
    out = tmp_path / 'sweep.jsonl'
    for key, value in (('SWEEP_CAMERAS', 3), ('SWEEP_WIDTH', 96),
                       ('SWEEP_HEIGHT', 64), ('SWEEP_DURATION', 4),
                       ('SWEEP_PORT', _free_port()),
                       ('SWEEP_WARM_DEADLINE', 120),
                       ('SWEEP_MODEL', 'ssd_tiny_test'),
                       ('SWEEP_OUT', out)):
        tiny_model.setenv(key, str(value))
    tiny_model.setattr(bench, 'SWEEP_REFILL_S', 1.0)
    row = bench.run_sweep(torch.device('cpu'))
    keys = _script_record_keys('latency_sweep', 'row')
    assert set(row) == (keys - {'tunnel'}) | {'link', 'device'}
    assert row['bucket'] == 4 and row['platform'] == 'cpu'
    assert row['link'] is None and row['resolution'] == '96x64'
    assert row['detector_fps'] > 0
    assert row['detector_latency_ms_p50'] <= row['detector_latency_ms_p95']
    assert 'WATSOR_MIN_BUCKET' not in os.environ
    assert json.loads(out.read_text()) == row


def test_profile_app_splits_the_steps_on_the_cpu(tiny_model):
    """``profile_step --path app``'s windows on a short CPU run at the
    same size: every step of the first window timed (each batch padded
    to a bucket, a cycle at least its dispatch), the detector task's
    parts within the window, the process's CPU time, and the patched
    methods restored afterwards."""
    from watsor_tpu_torch import profile_step
    from watsor_tpu_torch.detection import TorchDetectorBackend
    from watsor_tpu_torch.detection.backend import _BUCKETS
    from watsor_tpu_torch.detection.detector import ObjectDetector
    for key, value in (('BASELINE5_CAMERAS', 4), ('BASELINE5_DURATION', 8),
                       ('BASELINE5_PORT', _free_port()),
                       ('BASELINE5_WARM_DEADLINE', 120),
                       ('WATSOR_MODEL', 'ssd_tiny_test')):
        tiny_model.setenv(key, str(value))
    run_app = bench.run_app
    tiny_model.setattr(bench, 'run_app', lambda device, **kw: run_app(
        device, frame_hw=(64, 96), **kw))
    saved = (TorchDetectorBackend.dispatch, TorchDetectorBackend.resolve,
             ObjectDetector._stage, ObjectDetector._scatter)
    results = {}
    profile_step.profile_app(torch.device('cpu'), results, window_s=1.5)
    assert (TorchDetectorBackend.dispatch, TorchDetectorBackend.resolve,
            ObjectDetector._stage, ObjectDetector._scatter) == saved
    split = results['app_steps']
    assert split['steps'] >= 2 and split['frames_per_s'] > 0
    assert 1 <= split['batch_min'] <= split['batch_max']
    assert set(split['buckets']) <= set(_BUCKETS)
    assert max(split['buckets']) >= split['batch_max']
    assert sum(split['buckets'].values()) == split['steps']
    assert split['cycle_ms'][0] >= split['dispatch_ms'][0] > 0
    assert split['stage_ms'][0] > 0 and split['scatter_ms'][0] > 0
    shares = split['shares']
    assert set(shares) == {'stage', 'dispatch', 'wait', 'finish', 'scatter',
                           'other'}
    assert abs(sum(shares.values()) - 1.0) < 1e-3
    assert 0 < shares['dispatch'] < 1.5
    assert split['process_cpu_cores'] > 0
    assert results['app_profile']['steps_under_profiler']['steps'] >= 1
    assert results['app']['detector_fps'] > 0
    assert 'samples' not in results['app']
