"""The port's seam to the JAX package, the workload chip_smoke.py and
profile_step drive, and chip_smoke.py's refusal to report without a card.

chip_smoke.py and the port must reach the JAX package only through
watsor_tpu_torch/host.py (its JAX-free host layers) and the Application
class that watsor_tpu_torch/main.py subclasses."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from watsor_tpu_torch import workload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'watsor_tpu_torch')
# module -> what it may import from the JAX package
SEAM = {'watsor_tpu_torch/host.py': None,
        'watsor_tpu_torch/main.py': {'watsor_tpu.main'}}


def _jax_package_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
        elif isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
    return {n for n in names
            if n.split('.')[0] in ('watsor_tpu', 'jax', 'jaxlib', 'flax')}


def _sources():
    yield 'chip_smoke.py'
    for folder, _, files in os.walk(PORT):
        for name in sorted(files):
            if name.endswith('.py'):
                yield os.path.relpath(os.path.join(folder, name), ROOT)


@pytest.mark.parametrize('source', sorted(_sources()))
def test_only_the_host_seam_reaches_the_jax_package(source):
    found = _jax_package_imports(os.path.join(ROOT, source))
    assert not {n for n in found if n.split('.')[0] != 'watsor_tpu'}, found
    allowed = SEAM.get(source, set())
    if allowed is not None:
        assert found <= allowed, found


def test_camera_filters_put_the_demo_mask_on_the_first_camera():
    cameras = ['cam{}'.format(i) for i in range(3)]
    tables, refiners = workload.camera_filters(cameras, (120, 160))
    assert list(refiners) == ['cam0'] and set(tables) == set(cameras)
    conf, area, zone_sat, zone_allow = tables['cam0']
    watched = sorted(workload.watched_labels())
    assert np.isfinite(conf[watched]).all()
    assert np.isinf(np.delete(conf, watched)).all()
    assert zone_sat.any() and zone_allow.any()
    assert not tables['cam1'][2].any()        # no mask, no zones


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=120, cwd=cwd, env=env)


def test_chip_smoke_reports_nothing_without_a_card(tmp_path):
    """No card (and, alone in a directory, no port): non-zero exit and no
    result line."""
    alone = tmp_path / 'chip_smoke.py'
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), alone)
    for cwd, script in ((ROOT, 'chip_smoke.py'), (tmp_path, str(alone))):
        proc = _run_smoke(cwd, script)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout


@pytest.mark.cuda
def test_profile_step_runs_on_the_card(tmp_path):
    """The step profile completes and reports device times (run on the
    card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with nvcc')
    proc = subprocess.run(
        [sys.executable, '-m', 'watsor_tpu_torch.profile_step', '--steps',
         '3', '--trace', str(tmp_path / 'trace.json')],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['detect_step_device_ms'] > 0
    assert 0 < result['profile']['busy_share'] <= 1
    assert (tmp_path / 'trace.json').exists()


@pytest.mark.cuda
def test_profile_step_int8_path_runs_on_the_card():
    """The int8 path's step profile completes and reports device times
    (run on the card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with nvcc')
    proc = subprocess.run(
        [sys.executable, '-m', 'watsor_tpu_torch.profile_step', '--path',
         'int8', '--steps', '3'], capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['path'] == 'int8' and result['detect_step_device_ms'] > 0
    assert set(result['launch_host_us']) == {'int8_matmul_requant',
                                             'pallas_suppress'}
