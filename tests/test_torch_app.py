"""TorchApplication end to end on the CPU, the port's counterpart of
tests/test_app_real_backend.py: the real zoo-built model (the 3-class
shapes geometry at 300x300), device filters, a synthetic camera, HTTP.
Also: booting the port never imports jax, and the device pool refuses to
fall back to the CPU on its own."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from watsor_tpu.main import _parse_commandline_arguments
from watsor_tpu_torch.detection.detector import resolve_device_pool
from watsor_tpu_torch.main import TorchApplication

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = """
http:
  port: {port}
{extra}
cameras:
  - cam_t:
      width: 160
      height: 120
      input: synthetic://shapes
      detect:
        - person: {{confidence: 10, area: 1}}
        - car: {{confidence: 10, area: 1}}
      ffmpeg:
        decoder: [-i, -f, rawvideo, -pix_fmt, rgb24]
"""


def _free_port():
    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _args(tmp_path, extra=''):
    port = _free_port()
    config_file = tmp_path / 'config.yaml'
    config_file.write_text(CONFIG.format(port=port, extra=extra))
    return port, _parse_commandline_arguments([
        '-c', str(config_file), '--model', 'ssd_mobilenet_v2_shapes',
        '-m', str(tmp_path / 'no_weights')])


def _serve(tmp_path, extra=''):
    """Run TorchApplication until detections flow; returns (app, metrics)."""
    port, args = _args(tmp_path, extra)
    app = TorchApplication(args)
    thread = threading.Thread(target=app.run, daemon=True)
    thread.start()
    url = 'http://127.0.0.1:{}'.format(port)
    metrics = None
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(url + '/metrics',
                                            timeout=2) as response:
                    metrics = json.loads(response.read())
                detectors = metrics.get('detectors') or []
                if detectors and detectors[0]['fps'] > 0:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        else:
            pytest.fail('no detections flowed: {}'.format(metrics))
        assert [d['name'] for d in metrics['detectors']] == ['CPU 0']
        assert metrics['cameras'][0]['fps']['decoder'] > 0
        with urllib.request.urlopen(url + '/health', timeout=2) as response:
            assert response.read() == b'UP'
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + '/profiler', timeout=2)
        assert err.value.code == 501
        # the camera's filters went to the device as tables
        assert set(app._camera_tables) == {'cam_t'}
    finally:
        app._stop_main.set()
        thread.join(30)
    assert not thread.is_alive()
    return app, metrics


_KNOBS = ('WATSOR_QUANTIZE', 'WATSOR_FLEET', 'WATSOR_FUSED_BLOCKS',
          'TRT_FLOAT_PRECISION', 'WATSOR_DEVICE_RENDER', 'WATSOR_CALIB_FILE',
          'WATSOR_INT8_POINTWISE')


def _clear_knobs(monkeypatch):
    monkeypatch.setenv('WATSOR_DEVICE_POOL', 'cpu:1')
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)


def test_torch_app_serves_detections(tmp_path, monkeypatch):
    _clear_knobs(monkeypatch)
    _serve(tmp_path)


@pytest.mark.parametrize('quantize,pointwise', [('int8_full', 'pallas'),
                                                ('int8', None)])
def test_torch_app_serves_int8_with_exact_nms(tmp_path, monkeypatch,
                                              quantize, pointwise):
    """WATSOR_QUANTIZE=int8_full (calibrated on seeded noise, pointwise
    units through the kernel wrapper) and int8 (int8 weights dequantized
    each step), with the classic per-class ``nms: exact``."""
    _clear_knobs(monkeypatch)
    monkeypatch.setenv('WATSOR_QUANTIZE', quantize)
    if pointwise:
        monkeypatch.setenv('WATSOR_INT8_POINTWISE', pointwise)
    app, _ = _serve(tmp_path, extra='nms: exact')
    detector = app._detectors[0]._backend._detector
    assert detector.config.nms_mode == 'exact'
    assert (detector.model is None) == (quantize == 'int8_full')


def test_missing_calibration_file_raises(tmp_path, monkeypatch):
    _clear_knobs(monkeypatch)
    monkeypatch.setenv('WATSOR_QUANTIZE', 'int8_full')
    monkeypatch.setenv('WATSOR_CALIB_FILE', str(tmp_path / 'none.npz'))
    _, args = _args(tmp_path)
    app = TorchApplication(args)
    with pytest.raises(SystemExit, match='does not exist'):
        app._setup(app._read_config())


def test_int8_weights_refuse_fused_blocks(tmp_path, monkeypatch):
    """int8 weights cannot feed the fused pack, which folds float kernels."""
    _clear_knobs(monkeypatch)
    monkeypatch.setenv('WATSOR_QUANTIZE', 'int8')
    monkeypatch.setenv('WATSOR_FUSED_BLOCKS', '1')
    _, args = _args(tmp_path)
    app = TorchApplication(args)
    with pytest.raises(SystemExit, match='WATSOR_FUSED_BLOCKS'):
        app._setup(app._read_config())


_BOOT = r"""
import sys, threading, time
from watsor_tpu.main import _parse_commandline_arguments
from watsor_tpu_torch.main import TorchApplication
app = TorchApplication(_parse_commandline_arguments(sys.argv[1:]))
thread = threading.Thread(target=app.run, daemon=True)
thread.start()
deadline = time.time() + 120
while time.time() < deadline:
    if app._detectors and app._detectors[0].fps.fps > 0:
        break
    time.sleep(0.2)
app._stop_main.set()
thread.join(30)
assert app._detectors and app._detectors[0].fps.fps > 0, 'no detections'
print('JAX_IMPORTED', 'jax' in sys.modules)
"""


def test_booting_the_port_never_imports_jax(tmp_path):
    _, args = _args(tmp_path)
    env = dict(os.environ, WATSOR_DEVICE_POOL='cpu:1', PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, '-c', _BOOT, '-c', args.config,
         '--model', 'ssd_mobilenet_v2_shapes', '-m', args.model_path],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'JAX_IMPORTED False' in proc.stdout, proc.stdout


def test_device_pool_refuses_a_silent_cpu_fallback(monkeypatch):
    monkeypatch.delenv('WATSOR_DEVICE_POOL', raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='No CUDA device'):
            resolve_device_pool()
        with pytest.raises(RuntimeError, match='No CUDA device'):
            resolve_device_pool('cuda:1')
    assert [d.type for d in resolve_device_pool('cpu:1')] == ['cpu']


@pytest.mark.parametrize('knob,value', [('WATSOR_FLEET', '1'),
                                        ('WATSOR_DEVICE_RENDER', '1')])
def test_unported_knobs_raise(tmp_path, monkeypatch, knob, value):
    monkeypatch.setenv('WATSOR_DEVICE_POOL', 'cpu:1')
    monkeypatch.setenv(knob, value)
    _, args = _args(tmp_path)
    app = TorchApplication(args)
    with pytest.raises(SystemExit, match='ROADMAP'):
        app._setup(app._read_config())
