"""TorchApplication end to end on the CPU, the port's counterpart of
tests/test_app_real_backend.py: the real zoo-built model (the 3-class
shapes geometry at 300x300), device filters, a synthetic camera, HTTP.
Also: booting the port imports neither jax nor the JAX package, and the
device pool refuses to fall back to the CPU on its own."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from watsor_tpu_torch.detection import TorchDetectorBackend
from watsor_tpu_torch.detection.detector import resolve_device_pool
from watsor_tpu_torch.main import (TorchApplication,
                                   _parse_commandline_arguments)

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


def _args(tmp_path, extra='', model='ssd_mobilenet_v2_shapes'):
    port = _free_port()
    config_file = tmp_path / 'config.yaml'
    config_file.write_text(CONFIG.format(port=port, extra=extra))
    return port, _parse_commandline_arguments([
        '-c', str(config_file), '--model', model,
        '-m', str(tmp_path / 'no_weights')])


def _serve(tmp_path, extra='', model='ssd_mobilenet_v2_shapes',
           during=None):
    """Run TorchApplication until detections flow, then ``during(app, url)``
    where given; returns (app, metrics)."""
    port, args = _args(tmp_path, extra, model)
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
        _check_profiler(app, url, tmp_path)
        # the camera's filters went to the device as tables
        assert set(app._camera_tables) == {'cam_t'}
        if during is not None:
            during(app, url)
    finally:
        app._stop_main.set()
        thread.join(30)
    assert not thread.is_alive()
    return app, metrics


def _check_profiler(app, url, tmp_path):
    """GET /profiler answers 200 with its trace's directory, which holds a
    trace on disk; a second request while the first captures is answered
    409 (watsor_tpu/main.py:732-770)."""
    app._args.log_path = str(tmp_path)
    answers = {}

    def capture():
        with urllib.request.urlopen(url + '/profiler?seconds=2',
                                    timeout=60) as response:
            answers['first'] = response.status, json.loads(response.read())

    first = threading.Thread(target=capture)
    first.start()
    time.sleep(0.5)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + '/profiler?seconds=1', timeout=30)
    assert err.value.code == 409
    first.join(60)
    assert not first.is_alive()
    status, body = answers['first']
    assert status == 200 and body['seconds'] == 2.0
    assert os.path.dirname(body['trace_dir']) == str(tmp_path)
    assert os.path.basename(body['trace_dir']).startswith('watsor-trace-')
    trace = os.path.join(body['trace_dir'], 'trace.json')
    assert os.path.getsize(trace) > 0
    with open(trace) as f:
        assert json.load(f)['traceEvents']


def _stalled_viewer(port, path):
    """A client that asks for ``path``, reads the first bytes of the answer
    and then reads no more."""
    client = socket.create_connection(('127.0.0.1', port), timeout=10)
    client.sendall('GET {} HTTP/1.1\r\nHost: localhost\r\n\r\n'
                   .format(path).encode())
    assert client.recv(256).startswith(b'HTTP/1.1 200')
    return client


def test_http_server_cuts_a_stalled_stream_at_shutdown():
    """A viewer that stopped reading blocks its request thread in a write;
    close_requests cuts the connection and the thread ends."""
    from watsor_tpu_torch.main import make_http_server

    def app(environ, start_response):
        start_response('200 OK', [('Content-Type',
                                   'application/octet-stream')])
        return iter(lambda: b'x' * 65536, None)       # never ends

    server = make_http_server(0, app, host='127.0.0.1')
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    client = _stalled_viewer(server.server_address[1], '/')
    try:
        deadline = time.time() + 10
        while not server._open and time.time() < deadline:
            time.sleep(0.05)
        handlers = [t for t in server._open.values() if t is not None]
        time.sleep(0.5)                 # the socket buffers fill
        assert handlers and all(t.is_alive() for t in handlers)
        server.shutdown()
        assert server.close_requests(grace_s=0.5) == []
        serving.join(5)
        assert not serving.is_alive()
        assert not any(t.is_alive() for t in handlers)
    finally:
        client.close()


def test_shutdown_ends_the_mjpeg_request_threads(tmp_path, monkeypatch):
    """The application's shutdown leaves no HTTP request thread behind,
    even for an MJPEG viewer that stopped reading."""
    _clear_knobs(monkeypatch)
    seen = {}

    def during(app, url):
        port = int(url.rsplit(':', 1)[1])
        seen['client'] = _stalled_viewer(port, '/video/mjpeg/cam_t')
        time.sleep(1.0)
        seen['threads'] = [t for t in app._http_server._open.values()
                           if t is not None]

    try:
        app, _ = _serve(tmp_path, during=during)
    finally:
        if 'client' in seen:
            seen['client'].close()
    assert seen['threads']
    assert not any(t.is_alive() for t in seen['threads'])
    assert app._http_server._open == {}


_KNOBS = ('WATSOR_QUANTIZE', 'WATSOR_FLEET', 'WATSOR_FUSED_BLOCKS',
          'TRT_FLOAT_PRECISION', 'WATSOR_DEVICE_RENDER', 'WATSOR_CALIB_FILE',
          'WATSOR_INT8_POINTWISE', 'WATSOR_FUSED_HEADS')


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


def test_torch_app_serves_efficientdet(tmp_path, monkeypatch):
    """efficientdet_lite0 at full size on the CPU, the default NMS: the
    detect plane takes the model's 320x320 input."""
    _clear_knobs(monkeypatch)
    app, _ = _serve(tmp_path, model='efficientdet_lite0')
    assert app.DETECT_SIZE == 320
    detector = app._detectors[0]._backend._detector
    assert detector.config.input_size == 320 and detector.anchors.shape == \
        (19206, 4)


def _factory(tmp_path, monkeypatch, model, **knobs):
    """The application's detector factory for ``model`` under ``knobs``."""
    _clear_knobs(monkeypatch)
    for knob, value in knobs.items():
        monkeypatch.setenv(knob, value)
    _, args = _args(tmp_path, model=model)
    app = TorchApplication(args)
    return app, app._detector_factory(app._read_config())


@pytest.mark.parametrize('model,size', [('ssd_mobilenet_v1', 300),
                                        ('ssd_inception_v2', 300),
                                        ('efficientdet_lite2', 448),
                                        ('efficientdet_lite4', 640)])
def test_detect_size_follows_the_model(tmp_path, monkeypatch, model, size):
    app, _ = _factory(tmp_path, monkeypatch, model)
    assert app.DETECT_SIZE == size


@pytest.mark.parametrize('model', ['ssd_inception_v2', 'ssdlite_mobilenet_v2',
                                   'ssd_mobilenet_v1', 'efficientdet_lite0'])
def test_fused_blocks_refuse_other_families(tmp_path, monkeypatch, model):
    """WATSOR_FUSED_BLOCKS=1 covers the plain ssd_mobilenet_v2 only, as in
    the JAX package (watsor_tpu/main.py:519-528)."""
    with pytest.raises(SystemExit, match='plain ssd_mobilenet_v2'):
        _factory(tmp_path, monkeypatch, model, WATSOR_FUSED_BLOCKS='1')


@pytest.mark.parametrize('model', ['efficientdet_lite0', 'ssd_mobilenet_v1'])
def test_int8_full_refuses_other_families(tmp_path, monkeypatch, model):
    with pytest.raises(SystemExit, match='plain ssd_mobilenet_v2'):
        _factory(tmp_path, monkeypatch, model, WATSOR_QUANTIZE='int8_full')


def test_int8_weights_cover_the_ssd_families(tmp_path, monkeypatch):
    """WATSOR_QUANTIZE=int8 applies to every ssd_ model
    (watsor_tpu/main.py:469): ssd_mobilenet_v1 builds the quantized
    detector, every conv kernel an int8 leaf."""
    from watsor_tpu_torch.models.quantize import QuantizedLeaf
    _, make = _factory(tmp_path, monkeypatch, 'ssd_mobilenet_v1',
                       WATSOR_QUANTIZE='int8')
    detector = make(torch.device('cpu'))
    params = detector.variables['params']
    assert isinstance(params['backbone']['unit1_depthwise']['Conv_0'][
        'kernel'], QuantizedLeaf)
    assert isinstance(params['cls_head0']['kernel'], QuantizedLeaf)
    assert detector.model.backbone.stem.conv.weight.device.type == 'meta'


def test_int8_weights_leave_efficientdet_float(tmp_path, monkeypatch):
    """...and to no EfficientDet, which stays float, as in the JAX
    package."""
    _, make = _factory(tmp_path, monkeypatch, 'efficientdet_lite0',
                       WATSOR_QUANTIZE='int8')
    detector = make(torch.device('cpu'))
    kernel = detector.variables['params']['cls_head']['predict']['pw'][
        'kernel']
    assert isinstance(kernel, np.ndarray) and kernel.dtype == np.float32


@pytest.mark.parametrize('model', ['efficientdet_lite9', 'efficientdet_d0',
                                   'ssd_resnet50'])
def test_unknown_models_exit(tmp_path, monkeypatch, model):
    """A name outside the zoo exits, an unknown EfficientDet-Lite variant
    naming the supported ones (watsor_tpu/main.py:145-152)."""
    with pytest.raises(SystemExit, match='lite0'
                       if model.startswith('efficientdet_') else 'available'):
        _factory(tmp_path, monkeypatch, model)


def test_fused_heads_knob_reaches_efficientdet(tmp_path, monkeypatch):
    _, make = _factory(tmp_path, monkeypatch, 'efficientdet_lite0',
                       WATSOR_FUSED_HEADS='1')
    detector = make(torch.device('cpu'))
    assert detector.config.fused_heads
    assert 'dual_head' in detector.variables['params']


_BOOT = r"""
import sys, threading, time
from watsor_tpu_torch.main import TorchApplication, _parse_commandline_arguments
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
print('JAX_PACKAGE_IMPORTED', sorted(
    m for m in sys.modules if m.split('.')[0] == 'watsor_tpu'))
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
    assert 'JAX_PACKAGE_IMPORTED []' in proc.stdout, proc.stdout


def test_device_pool_refuses_a_silent_cpu_fallback(monkeypatch):
    monkeypatch.delenv('WATSOR_DEVICE_POOL', raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='No CUDA device'):
            resolve_device_pool()
        with pytest.raises(RuntimeError, match='No CUDA device'):
            resolve_device_pool('cuda:1')
    assert [d.type for d in resolve_device_pool('cpu:1')] == ['cpu']


def _effect_types(app):
    """The effect classes of every camera's visual effects and snapshot."""
    return {type(e).__name__ for c in app._cameras
            for e in c.visual_effects._effects + c.snapshot._effects}


def _set_up(tmp_path, monkeypatch, extra='', **knobs):
    """TorchApplication built (not run) on the CPU pool under ``knobs``."""
    _clear_knobs(monkeypatch)
    for knob, value in knobs.items():
        monkeypatch.setenv(knob, value)
    _, args = _args(tmp_path, extra)
    app = TorchApplication(args)
    app._setup(app._read_config())
    return app


@pytest.mark.parametrize('knob,value', [('WATSOR_FLEET', '1'),
                                        ('WATSOR_DEVICE_RENDER', '1')])
def test_unported_knobs_raise(tmp_path, monkeypatch, knob, value):
    """The fleet and device-render knobs, which raised until the port had
    their paths, now boot on the CPU pool: WATSOR_FLEET=1 builds one
    ``detector-fleet`` over a FleetBackend with device render on by
    default; WATSOR_DEVICE_RENDER=1 alone puts DeviceDrawEffect over the
    usual detectors."""
    from watsor_tpu_torch.detection import FleetBackend
    app = _set_up(tmp_path, monkeypatch, **{knob: value})
    assert 'DeviceDrawEffect' in _effect_types(app)
    assert 'DrawEffect' not in _effect_types(app)
    assert app._device_renderer.device == torch.device('cpu')
    names = [d.name for d in app._detectors]
    backend = app._detectors[0]._backend
    if knob == 'WATSOR_FLEET':
        assert names == ['detector-fleet']
        assert isinstance(backend, FleetBackend)
        assert backend.device_name == 'CPU MESH {data: 1}'
        assert app._mesh.devices == (torch.device('cpu'),)
    else:
        assert names == ['detector1'] and app._mesh is None
        assert isinstance(backend, TorchDetectorBackend)


def test_fleet_with_host_drawing(tmp_path, monkeypatch):
    """WATSOR_DEVICE_RENDER=0 keeps cv2 drawing under the fleet."""
    app = _set_up(tmp_path, monkeypatch, WATSOR_FLEET='1',
                  WATSOR_DEVICE_RENDER='0')
    assert [d.name for d in app._detectors] == ['detector-fleet']
    assert 'DrawEffect' in _effect_types(app)
    assert 'DeviceDrawEffect' not in _effect_types(app)
    assert app._device_renderer is None


MASKED = """
  - cam_m:
      width: 160
      height: 120
      input: synthetic://shapes
      mask: {mask}
      detect:
        - person: {{confidence: 10, area: 1, zones: [1]}}
      ffmpeg:
        decoder: [-i, -f, rawvideo, -pix_fmt, rgb24]
"""


def test_fleet_keeps_contours_for_a_masked_camera(tmp_path, monkeypatch):
    """A camera with a zone mask keeps the host chain (blend, contours);
    the maskless camera beside it draws on the device."""
    import cv2
    mask = tmp_path / 'mask.png'
    image = np.zeros((120, 160, 4), np.uint8)
    image[10:60, 10:80, 3] = 255
    cv2.imwrite(str(mask), image)
    _clear_knobs(monkeypatch)
    monkeypatch.setenv('WATSOR_FLEET', '1')
    port, args = _args(tmp_path)
    config = tmp_path / 'config.yaml'
    config.write_text(config.read_text() + MASKED.format(mask=mask))
    app = TorchApplication(args)
    app._setup(app._read_config())
    effects = {c.name: [type(e).__name__ for e in c.visual_effects._effects]
               for c in app._cameras}
    assert effects['cam_m'][-1] == 'DrawEffectWithContours'
    assert effects['cam_t'][-1] == 'DeviceDrawEffect'
    assert [d.name for d in app._detectors] == ['detector-fleet']


def test_fleet_app_equals_single_device(tmp_path, monkeypatch):
    """testing/fleet_app.run_app on the CPU pool: 4 cameras of 96x64, zone
    masks, device filters, the tiny SSD, once with WATSOR_FLEET=1 and once
    without; the MQTT detail payloads agree camera by camera."""
    from watsor_tpu_torch.models import zoo
    from watsor_tpu_torch.testing.fleet_app import run_app, tiny_ssd_config
    _clear_knobs(monkeypatch)
    monkeypatch.setitem(zoo.MODEL_REGISTRY, 'ssd_tiny_test',
                        tiny_ssd_config())
    kw = dict(n_cams=4, frame_hw=(64, 96), device_pool='cpu:1',
              steady_timeout=60, details_timeout=60, min_camera_frac=1.0)
    fleet, fleet_name = run_app(tmp_path, True, **kw)
    single, single_name = run_app(tmp_path, False, **kw)
    assert fleet_name == 'CPU MESH {data: 1}' and single_name == 'CPU 0'
    assert sorted(fleet) == sorted(single) == ['cam00', 'cam01', 'cam02',
                                               'cam03']
    assert fleet == single


@pytest.mark.parametrize('precision,tf32', [('32', False), ('16', True)])
def test_f32_service_turns_tf32_off(tmp_path, monkeypatch, precision, tf32):
    """TRT_FLOAT_PRECISION=32 builds an f32 detector in full f32: cuDNN's
    and cuBLAS's TF32 switches go off for the process; bf16 leaves them."""
    _clear_knobs(monkeypatch)
    monkeypatch.setenv('TRT_FLOAT_PRECISION', precision)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    _, args = _args(tmp_path)
    app = TorchApplication(args)
    app._detector_factory(app._read_config())
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
