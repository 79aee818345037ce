"""The port's measurement legs (watsor_tpu_torch/measure/, the subcommands
``host``, ``nms``, ``int8``, ``overlap``, ``models``, ``overlay`` and
``restart`` of ``python -m watsor_tpu_torch.bench``) on the CPU against the
scripts they port: scripts/host_budget.py, measure_nms_modes.py,
validate_nms_modes.py, measure_nms_active.py, bench_int8_full.py,
measure_overlap.py, roofline.py, validate_timing.py, measure_overlay.py
and warm_restart.py.

Each leg runs at a tiny size (batch 1, 64x64 inputs where the script
hard-codes 300, short chains, 20 repetitions a host stage and one a JPEG
encode) and its record's keys are held to the script's, read with ``ast``
(running a script builds and compiles the JAX detector). The derived
numbers are held to the scripts' formulas on fixed numbers: imported from
the script where the formula is a top-level function, else restated once
with its line. On the
card ``chip_smoke.py`` phase 11 runs the legs at full size."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from watsor_tpu_torch import bench, timing
from watsor_tpu_torch.measure import (host_budget, int8_full, nms_modes,
                                      overlap, roofline_table, warm_restart)
from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_VARS = ('HOST_BUDGET_OUT', 'NMS_OUT', 'INT8_FULL_OUT', 'OVERLAP_RESULTS',
            'ROOFLINE_OUT', 'VALIDATE_OUT', 'WARM_RESTART_OUT')
KNOBS = OUT_VARS + ('BENCH_BATCH', 'BENCH_STEPS', 'N_SHORT', 'N_LONG',
                    'WATSOR_INT8_POINTWISE', 'WATSOR_FUSED_HEADS',
                    'WATSOR_KERNEL_CACHE_DIR')
# what each leg writes, and to which variable, where that is set
WRITES = {'host': ['HOST_BUDGET_OUT'], 'nms': ['NMS_OUT'],
          'int8': ['INT8_FULL_OUT'], 'overlap': ['OVERLAP_RESULTS'],
          'models': ['ROOFLINE_OUT', 'VALIDATE_OUT'], 'overlay': [],
          'restart': ['WARM_RESTART_OUT']}
LEGS = {'host': ['host'], 'nms': ['nms'], 'int8': ['int8'],
        'overlap': ['overlap'], 'models': ['models', 'efficientdet_lite0'],
        'overlay': ['overlay', '2', '64', '96'], 'restart': ['restart']}


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """The legs at a tiny size, run from an empty working directory."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for key, value in (('BENCH_BATCH', 1), ('BENCH_STEPS', 2),
                       ('N_SHORT', 1), ('N_LONG', 2),
                       # the restart leg's children: one thread each
                       ('OMP_NUM_THREADS', 1)):
        monkeypatch.setenv(key, str(value))
    monkeypatch.setattr(host_budget, 'REPS',
                        dict.fromkeys(host_budget.REPS, 20))
    monkeypatch.setitem(host_budget.REPS, 'jpeg_1080p', 1)
    monkeypatch.setitem(host_budget.REPS, 'jpeg_viewer', 1)
    monkeypatch.setattr(nms_modes, 'INPUT_SIZE', 64)
    monkeypatch.setattr(int8_full, 'INPUT_SIZE', 64)
    monkeypatch.setattr(overlap, 'BATCHES', (1, 2))
    monkeypatch.setattr(overlap, 'REPS', 1)
    monkeypatch.setattr(warm_restart, 'BATCH', 1)
    # the zoo's quickest model to build on the CPU
    monkeypatch.setattr(warm_restart, 'MODEL', 'efficientdet_lite0')
    real = timing.chained_step_ms
    monkeypatch.setattr(timing, 'chained_step_ms', lambda run, **kw: real(
        run, n_short=1, n_long=2, reps=1, log=kw.get('log')))
    workdir = tmp_path / 'cwd'
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    return monkeypatch


def _run(argv, capsys):
    """``bench.main(argv + --device cpu)``: (exit code, its one stdout
    line as JSON)."""
    rc = bench.main(argv + ['--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


# -- the scripts' keys, read with ast ----------------------------------------

def _tree(name):
    with open(os.path.join(ROOT, 'scripts', name + '.py')) as f:
        return ast.parse(f.read())


def _keys(node):
    return {k.value for k in node.keys}


def _assigned_dicts(name, variable):
    """The keys of every dict literal assigned to ``variable`` in
    scripts/<name>.py."""
    return [_keys(node.value) for node in ast.walk(_tree(name))
            if isinstance(node, ast.Assign) and
            isinstance(node.targets[0], ast.Name) and
            node.targets[0].id == variable and isinstance(node.value, ast.Dict)]


def _call_dicts(name, func):
    """The keys of every dict literal passed to ``func(...)`` (an attribute
    call such as ``json.dumps`` or ``rows.append``) in scripts/<name>.py."""
    return [_keys(node.args[0]) for node in ast.walk(_tree(name))
            if isinstance(node, ast.Call) and
            isinstance(node.func, ast.Attribute) and
            node.func.attr == func and node.args and
            isinstance(node.args[0], ast.Dict)]


def _subscript_keys(name, variable):
    """The constant keys of ``variable['...'] = ...`` in scripts/<name>.py."""
    return {node.targets[0].slice.value for node in ast.walk(_tree(name))
            if isinstance(node, ast.Assign) and
            isinstance(node.targets[0], ast.Subscript) and
            isinstance(node.targets[0].value, ast.Name) and
            node.targets[0].value.id == variable and
            isinstance(node.targets[0].slice, ast.Constant)}


def _script(name):
    """scripts/<name>.py imported by path (its top level reads only the
    environment)."""
    spec = importlib.util.spec_from_file_location(
        '_script_' + name, os.path.join(ROOT, 'scripts', name + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


DETAIL_KEYS = {'n_short', 'n_long', 'reps', 'compile_s', 'times_short_s',
               'times_long_s'}        # timing.chained_step_ms's detail


def _check_host(record):
    result, = _assigned_dicts('host_budget', 'result')
    assert set(record) == result | {'device'}
    assert set(record['per_stage_ms_per_frame']) == \
        _subscript_keys('host_budget', 'rows')
    assert set(record['host']) == {'cores', 'cpu_model', 'note'}
    assert all(v > 0 for v in record['per_stage_ms_per_frame'].values())
    assert record['cameras_per_core_at_30fps'] > 0


def _subscript_dicts(name, variable):
    """The keys of every dict literal assigned to ``variable[...]`` in
    scripts/<name>.py."""
    return [_keys(node.value) for node in ast.walk(_tree(name))
            if isinstance(node, ast.Assign) and
            isinstance(node.targets[0], ast.Subscript) and
            isinstance(node.targets[0].value, ast.Name) and
            node.targets[0].value.id == variable and
            isinstance(node.value, ast.Dict)]


def _check_nms(record):
    out, = _assigned_dicts('validate_nms_modes', 'out')
    line, = _call_dicts('measure_nms_modes', 'dumps')
    chained, = _assigned_dicts('validate_nms_modes', 'row')
    active, = _subscript_dicts('measure_nms_active', 'results')
    assert set(record) == out | {'active', 'device'}
    assert record['probe'] == 'nms_modes_ssd300' and record['batch'] == 1
    assert list(record['modes']) == list(nms_modes.MODES)
    for mode, row in record['modes'].items():
        assert set(row) == line | chained | DETAIL_KEYS
        assert row['mode'] == mode
    tags = [tag for _, tag in nms_modes.CLASSES]
    assert tags == ['C90', 'C2_person_car']      # measure_nms_active.py:268
    assert set(record['active']) == {'{}_{}'.format(t, m) for t in tags
                                     for m in nms_modes.MODES}
    for key, row in record['active'].items():
        assert set(row) == active | {'chained_ms_per_step', 'chained_fps'}
        if key.startswith('C90_'):
            mode = record['modes'][key[len('C90_'):]]
            assert (row['ms'], row['chained_ms_per_step']) == \
                (mode['ms_per_step'], mode['chained_ms_per_step'])


def _check_int8(record):
    results, = _assigned_dicts('bench_int8_full', 'results')
    row = next(keys for keys in _assigned_dicts('bench_int8_full', 'row')
               if 'ms' in keys)
    assert set(record) == results | set(int8_full.MODES) | {'device'}
    for mode in int8_full.MODES:
        assert set(record[mode]) == row and record[mode]['mode'] == mode
        assert record[mode]['scores_cosine_vs_bf16'] >= 0.95


def _check_overlap(record):
    keys, = _assigned_dicts('measure_overlap', 'record')
    row, = _call_dicts('measure_overlap', 'append')
    assert set(record) == keys
    assert [r['batch'] for r in record['rows']] == [1, 2]
    assert all(set(r) == row for r in record['rows'])


def _check_models(record):
    from watsor_tpu.roofline import roofline_row

    results, = _assigned_dicts('validate_timing', 'results')
    chained, = _assigned_dicts('validate_timing', 'row')
    assert set(record) == results | {'device'}
    row = record['models']['efficientdet_lite0']
    flops = row['gflops_per_frame'] * 1e9
    nbytes = row['hbm_mb_per_frame'] * 1e6
    jax_row = roofline_row('efficientdet_lite0', 1, row['ms_per_step'], flops,
                           nbytes, object())
    # roofline.py:216-217: the row and the device; validate_timing.py:
    # 299-307: the chained row and the harness's detail
    assert set(row) == set(jax_row) | {'device', 'flops_source'} | \
        chained | DETAIL_KEYS
    assert row['flops_source'] == roofline_table.FLOPS_SOURCE


def _check_overlay(record):
    line, = _call_dicts('measure_overlay', 'dumps')
    assert set(record) == line | {'device'}
    assert record['resolution'] == '96x64' and record['frames_per_s'] > 0


def _check_restart(record):
    rec, = _assigned_dicts('warm_restart', 'rec')
    leg = next(_keys(node.value) for node in ast.walk(_tree('warm_restart'))
               if isinstance(node, ast.Return) and
               isinstance(node.value, ast.Dict))
    assert set(record) == rec | {'device'}
    for name in ('cold', 'restart'):
        assert set(record[name]) == leg | {'kernel_build_s', 'kernels'}
        assert record[name]['kernels'] == {}     # no kernel on the CPU
    assert record['cache_entries'] == 0


CHECKS = {'host': _check_host, 'nms': _check_nms, 'int8': _check_int8,
          'overlap': _check_overlap, 'models': _check_models,
          'overlay': _check_overlay, 'restart': _check_restart}


@pytest.mark.parametrize('command', list(LEGS))
def test_leg_prints_the_scripts_keys(tiny, capsys, tmp_path, command):
    """Each leg on the CPU at a tiny size: exit 0, one JSON line with its
    script's keys (``device`` added: the card's name and power limit, here
    the CPU). With every leg's output variable set to a file outside the
    working directory, the leg writes the files of its own variables and
    nothing else, none in the working directory (the scripts write their
    files when their variables are unset; test_host_imports_nothing_of_jax
    runs ``host`` with its variable unset)."""
    for name in OUT_VARS:
        tiny.setenv(name, str(tmp_path / name))
    rc, record = _run(LEGS[command], capsys)
    assert rc == 0, record
    assert record['device'] == 'cpu'
    CHECKS[command](record)
    assert sorted(n for n in OUT_VARS if (tmp_path / n).exists()) == \
        sorted(WRITES[command])
    assert os.listdir('.') == []
    if command == 'host':
        assert json.loads((tmp_path / 'HOST_BUDGET_OUT').read_text()) == \
            record


def test_an_int8_mode_that_raises_fails_the_leg(tiny, capsys):
    """bench_int8_full.py:81-83 records a failed mode and goes on; the port
    fails the leg: bench.py's error record and exit 1."""
    tiny.setattr(int8_full, 'MODES', ('conv', 'no_such_mode'))
    rc, record = _run(['int8'], capsys)
    assert rc == 1
    assert set(record) == {'metric', 'value', 'unit', 'vs_baseline', 'error'}
    assert record['value'] == 0 and 'no_such_mode' in record['error']


def test_a_restart_child_that_fails_fails_the_leg(tiny, capsys):
    tiny.setattr(warm_restart, 'MODEL', 'no_such_model')
    rc, record = _run(['restart'], capsys)
    assert rc == 1
    assert record['value'] == 0 and 'leg failed' in record['error']
    assert os.listdir('.') == []


@pytest.mark.parametrize('command', list(LEGS))
def test_without_a_card_each_leg_exits_1(monkeypatch, capsys, command):
    """No card and no ``--device``: bench.py's error record, exit 1, and
    nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(bench, 'run_command', None)
    assert bench.main(LEGS[command]) == 1
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(record) == {'metric', 'value', 'unit', 'vs_baseline', 'error'}
    assert record['metric'] == bench.METRICS[command]
    assert 'no CUDA device' in record['error']


def test_host_imports_nothing_of_jax(tmp_path):
    """``bench host --device cpu`` in a process of its own, from an empty
    directory with ``HOST_BUDGET_OUT`` unset: one JSON line, no module of
    JAX or of the JAX package imported, and no file written."""
    code = (
        'import json, sys\n'
        'from watsor_tpu_torch import bench\n'
        'from watsor_tpu_torch.measure import host_budget\n'
        'host_budget.REPS = dict.fromkeys(host_budget.REPS, 1)\n'
        'rc = bench.main(["host", "--device", "cpu"])\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
        '             ("jax", "jaxlib", "flax", "watsor_tpu"))\n'
        'print(json.dumps(bad))\n'
        'sys.exit(rc)\n')
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    env.pop('HOST_BUDGET_OUT', None)
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    record, bad = [json.loads(line)
                   for line in proc.stdout.strip().splitlines()]
    assert bad == []
    assert record['device'] == 'cpu'
    assert os.listdir(tmp_path) == []


# -- the derived numbers against the scripts' formulas ------------------------

def test_overlap_formulas_equal_measure_overlap():
    rows = [{'batch': 4, 'pipelined_ms': 3.7}, {'batch': 8, 'pipelined_ms': 5.1},
            {'batch': 16, 'pipelined_ms': 8.3},
            {'batch': 32, 'pipelined_ms': 14.9}]
    for t_h2d, t_step, t_pipe in ((0.0012, 0.0051, 0.0055),
                                  (0.004, 0.003, 0.0069), (0.0, 0.003, 0.1)):
        # scripts/measure_overlap.py:85-86
        denom = min(t_h2d, t_step)
        want = (t_h2d + t_step - t_pipe) / denom if denom > 0 else 0.0
        assert overlap.overlap_fraction(t_h2d, t_step, t_pipe) == \
            pytest.approx(want, rel=1e-12, abs=0)
    # scripts/measure_overlap.py:99-108
    bs = np.array([r['batch'] for r in rows], np.float64)
    ts = np.array([r['pipelined_ms'] for r in rows], np.float64)
    b_slope, a_fixed = np.polyfit(bs, ts, 1)
    fixed, marginal, corrected = overlap.fixed_marginal_split(rows)
    assert fixed == pytest.approx(float(a_fixed), rel=1e-12)
    assert marginal == pytest.approx(float(b_slope), rel=1e-12)
    assert corrected == pytest.approx(1000.0 / b_slope, rel=1e-12)
    flat = [dict(r, pipelined_ms=9.0 - r['batch'] / 8) for r in rows]
    assert overlap.fixed_marginal_split(flat)[2] is None


def test_cameras_per_core_equals_host_budget():
    for per_frame in (0.9278, 1.5, 8.7):
        # scripts/host_budget.py:318-319
        fps = 30.0
        want = 1000.0 / (per_frame * fps)
        assert host_budget.cameras_per_core(per_frame) == \
            pytest.approx(want, rel=1e-12)


def test_cosine_equals_bench_int8_full():
    script = _script('bench_int8_full')
    rng = np.random.default_rng(3)
    for a, b in ((rng.random(200), rng.random(200)),
                 (rng.random((4, 100)), rng.random((4, 100)) - 0.5),
                 (np.zeros(10), np.ones(10))):
        assert int8_full._cosine(a, b) == pytest.approx(
            script._cosine(a, b), rel=1e-12, abs=0)


def test_restart_formulas_equal_warm_restart():
    for cold_s, warm_s in ((52.3, 11.8), (10.0, 9.7), (4.0, 0.0)):
        cold, warm = {'first_step_s': cold_s}, {'first_step_s': warm_s}
        # scripts/warm_restart.py:413-415
        speedup = round(cold['first_step_s'] /
                        max(warm['first_step_s'], 1e-9), 1)
        hit = warm['first_step_s'] < 0.5 * cold['first_step_s']
        assert warm_restart.speedup_first_step(cold, warm) == \
            pytest.approx(speedup, rel=1e-12)
        assert warm_restart.cache_hit(cold, warm) is hit


def test_model_names_follow_the_scripts():
    """roofline.py's nine by default, in its order."""
    assert roofline_table.ALL == _script('roofline').ALL
