"""The command's argument handling, its refusal without a CUDA device,
and its failure in a checkout that holds only the benchmark."""

import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.cpu import REPO, copy_benchmark


def test_arguments():
    args = run.parse(['--workload', 'lite4.sat64', '--seed', str(2 ** 33),
                      '--seconds', '20', '--trace', '1'])
    assert (args.workload, args.seed, args.seconds, args.trace) == \
        ('lite4.sat64', 2 ** 33, 20.0, 1)
    assert run.parse(['--workload', 'x', '--seed', '1',
                      '--seconds', '5']).trace == 0
    for bad in (['--seed', '1', '--seconds', '5'],
                ['--workload', 'x', '--seed', '1', '--seconds', '0'],
                ['--workload', 'x', '--seed', 'a', '--seconds', '5'],
                ['--workload', 'x', '--seed', '1', '--seconds', '5',
                 '--trace', '2']):
        with pytest.raises(SystemExit) as exc:
            run.parse(bad)
        assert exc.value.code == 2


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        run.main(['--workload', 'no.such', '--seed', '1', '--seconds', '1'])


def environ(**extra):
    env = dict(os.environ, **extra)
    env.pop('PYTHONPATH', None)
    return env


def command(cwd, extra_env=None):
    env = environ(BENCH_RUN='1', **(extra_env or {}))
    return subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload', 'lite4.sat64',
         '--seed', str(2 ** 31 + 5), '--seconds', '1', '--trace', '0'],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_cuda_device_exits_without_a_result():
    out = command(REPO, {'CUDA_VISIBLE_DEVICES': ''})
    assert out.returncode == 2
    assert out.stdout == ''
    assert 'CUDA' in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    root = copy_benchmark(tmp_path)
    out = command(root, {'CUDA_VISIBLE_DEVICES': ''})
    assert out.returncode != 0 and out.stdout == ''
    code = ('import time, torch\n'
            'from benchmark.lib import cell, spec\n'
            "c = spec.Cell(spec.load('.'), 'lite4.sat64', '.')\n"
            "cell.run(c, 1, 1.0, False, torch.device('cpu'), "
            'time.perf_counter())\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         env=environ(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ''
    assert "No module named 'watsor_tpu_torch'" in out.stderr


def test_environment_fixes_the_caches_inside_the_checkout(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv('WATSOR_MIN_BUCKET', '32')
    monkeypatch.setenv('WATSOR_KERNEL_CACHE_DIR', '/elsewhere')
    for key in ('TRITON_CACHE_DIR', 'TORCH_EXTENSIONS_DIR',
                'CUDA_CACHE_PATH'):
        monkeypatch.setenv(key, '/elsewhere')
    run.environment(str(tmp_path))
    assert 'WATSOR_MIN_BUCKET' not in os.environ
    for key in ('WATSOR_KERNEL_CACHE_DIR', 'TRITON_CACHE_DIR',
                'TORCH_EXTENSIONS_DIR', 'CUDA_CACHE_PATH'):
        assert os.environ[key].startswith(str(tmp_path) + os.sep)
