"""The port's command-line entry points on the CPU, against the JAX
package's where both run here: the zones tool (watsor_tpu_torch/zones.py)
and ``--check-config`` (watsor_tpu_torch/main.py) give the JAX package's
report, image bytes and exit codes; the build-ahead CLI
(watsor_tpu_torch/warmup.py), the reference's ``engine`` shim and the
``main_for_gpu`` launcher take the JAX package's arguments
(tests/test_warmup.py, test_engine_cli.py, test_launchers.py,
test_zones_cli.py and test_check_config.py of the JAX package). The
warmup's kernel build needs the card; on the CPU (WATSOR_DEVICE_POOL=cpu)
it builds nothing and runs the detector once a bucket."""

import argparse
import os
import re

import cv2
import numpy as np
import pytest
import torch

import watsor_tpu.main as jax_main
from watsor_tpu import zones as jax_zones
from watsor_tpu_torch import engine, main_for_gpu, warmup, zones
from watsor_tpu_torch import main as port_main
from watsor_tpu_torch.models import zoo
from watsor_tpu_torch.models.ssd import SSDConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'config', 'config.yaml')
MASK = os.path.join(ROOT, 'config', 'porch_mask.png')
TINY = SSDConfig(num_classes=2, input_size=96, width_multiplier=0.35,
                 extra_features=(32, 32, 32, 32))

CAMERAS = """
cameras:
{}"""
CAMERA = """  - cam{i}:
      width: 160
      height: 120
      input: synthetic://shapes
{mask}      detect:
        - person: {{confidence: 50, area: 1}}
        - car: {{confidence: 50, area: 1}}
      ffmpeg:
        decoder: [{decoder}]
"""
DECODER = '-i, -f, rawvideo, -pix_fmt, rgb24'


def _config(tmp_path, n=1, mask=None, decoder=DECODER, extra=''):
    path = tmp_path / 'config.yaml'
    path.write_text(extra + CAMERAS.format(''.join(CAMERA.format(
        i=i, decoder=decoder,
        mask='      mask: {}\n'.format(mask) if mask else '')
        for i in range(n))))
    return str(path)


# ---- zones ----------------------------------------------------------------

def test_zones_match_jax_on_the_demo_mask(tmp_path, capsys):
    """The zone table and the annotated image's bytes of the JAX package's
    tool on config/porch_mask.png."""
    ours, theirs = str(tmp_path / 'port.png'), str(tmp_path / 'jax.png')
    zones.main(['-m', MASK, '-o', ours])
    printed = capsys.readouterr().out
    jax_zones.main(['-m', MASK, '-o', theirs])
    assert printed.replace(ours, theirs) == capsys.readouterr().out
    assert 'zone  1' in printed
    with open(ours, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()
    rows, canvas = zones.annotate(MASK)
    want_rows, want_canvas = jax_zones.annotate(MASK)
    assert rows == want_rows and rows
    np.testing.assert_array_equal(canvas, want_canvas)


def _mask_png(path, h=120, w=160, zones_on=True):
    image = np.zeros((h, w, 4), np.uint8)
    image[:, :, :3] = 200
    if zones_on:
        image[10:50, 10:60, 3] = 255
        image[70:110, 100:150, 3] = 255
    cv2.imwrite(str(path), image)
    return str(path)


def test_zones_empty_mask_and_headless_show(tmp_path, capsys, monkeypatch):
    zones.main(['-m', _mask_png(tmp_path / 'empty.png', zones_on=False)])
    assert 'No zones found' in capsys.readouterr().out
    monkeypatch.delenv('DISPLAY', raising=False)
    monkeypatch.delenv('WAYLAND_DISPLAY', raising=False)
    zones.main(['-m', _mask_png(tmp_path / 'mask.png'), '--show'])
    printed = capsys.readouterr().out
    assert 'zone  2' in printed and 'No display available' in printed


# ---- --check-config -------------------------------------------------------

def _check(main, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv + ['--check-config'])
    return exc.value.code, capsys.readouterr().out


@pytest.mark.parametrize('case', ['demo', 'bad mask', 'bad model',
                                  'fallback flags', 'invalid'])
def test_check_config_reports_as_the_jax_package(tmp_path, capsys, case):
    """The same report lines and exit code as watsor_tpu.main's: the demo
    config, a camera whose mask is missing, an unknown model, decoder flags
    the native decoder does not translate, and a config that fails its
    schema."""
    argv = ['-c', CONFIG]
    if case == 'bad mask':
        argv = ['-c', _config(tmp_path, n=2,
                              mask=str(tmp_path / 'missing.png'))]
    elif case == 'bad model':
        argv += ['--model', 'not_a_model']
    elif case == 'fallback flags':
        argv = ['-c', _config(tmp_path, decoder='-ss, "1", -i, -vf, '
                              '"hue=s=0", -f, rawvideo, -pix_fmt, rgb24')]
    elif case == 'invalid':
        path = tmp_path / 'invalid.yaml'
        path.write_text('cameras:\n  - cam1:\n      width: 1\n')
        argv = ['-c', str(path)]
    got = _check(port_main.main, argv, capsys)
    want = _check(jax_main.main, argv, capsys)
    if case == 'bad model':
        # the unknown-model line lists each zoo's registry, and the port's
        # also names efficientdet_lite1..4 (the JAX zoo builds them through
        # lite_config without listing them)
        got, want = ((code, re.sub(r'; available: .*', '', out))
                     for code, out in (got, want))
    assert got == want
    code, out = got
    expected = {'demo': 0, 'bad mask': 1, 'bad model': 1,
                'fallback flags': 0, 'invalid': 1}[case]
    assert code == expected, out
    if case == 'demo':
        assert 'mask ok' in out and 'check-config: OK' in out
    if case == 'bad mask':
        assert '2 problem(s)' in out
    if case == 'fallback flags':
        assert 'WATSOR_FFMPEG_FALLBACK=1' in out


@pytest.mark.parametrize('case', ['demo', 'invalid'])
def test_python_m_check_config_as_the_jax_package(tmp_path, case):
    """``python -m watsor_tpu_torch --check-config`` (the package's
    ``__main__``) in a subprocess prints the report and exits with the
    code of ``python -m watsor_tpu --check-config``."""
    import subprocess
    import sys
    config = CONFIG
    if case == 'invalid':
        config = str(tmp_path / 'invalid.yaml')
        with open(config, 'w') as f:
            f.write('cameras:\n  - cam1:\n      width: 1\n')
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS='cpu')

    def run(package):
        proc = subprocess.run(
            [sys.executable, '-m', package, '-c', config, '--check-config'],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        return proc.returncode, proc.stdout

    got, want = run('watsor_tpu_torch'), run('watsor_tpu')
    assert got == want
    assert got[0] == (0 if case == 'demo' else 1), got[1]
    assert ('check-config: OK' if case == 'demo' else 'INVALID') in got[1]


# ---- warmup ---------------------------------------------------------------

@pytest.fixture
def tiny_model(monkeypatch):
    """A small SSD registered in the port's zoo, detected on the CPU."""
    monkeypatch.setitem(zoo.MODEL_REGISTRY, '_tiny_warmup', TINY)
    monkeypatch.setenv('WATSOR_DEVICE_POOL', 'cpu:1')
    for knob in ('WATSOR_FUSED_BLOCKS', 'WATSOR_QUANTIZE',
                 'TRT_FLOAT_PRECISION', 'WATSOR_KERNEL_CACHE_DIR'):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(warmup, 'build_kernels', lambda: pytest.fail(
        'no kernel is built for a CPU device'))
    return '_tiny_warmup'


def test_warmup_trims_the_buckets_to_the_cameras(tiny_model, tmp_path,
                                                 capsys):
    """-c derives the serving detector (its watched labels and NMS mode)
    and trims the buckets to 2x the cameras, rounded up to a bucket: 3
    cameras run 1, 2, 4 and 8 (watsor_tpu/warmup.py:67-80)."""
    config = _config(tmp_path, n=3, extra='nms: exact\n')
    args = argparse.Namespace(config=config, batches=[1, 2, 4, 8, 16, 32,
                                                      64])
    _, buckets = warmup.serving_spec(args)
    assert buckets == [1, 2, 4, 8]
    seen = []
    build = port_main.TorchApplication._detector_factory

    def spy(app, config, precision=None):
        make = build(app, config, precision)
        return lambda device: seen.append(make(device)) or seen[-1]

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(port_main.TorchApplication, '_detector_factory', spy)
        warmup.main(['-m', tiny_model, '-c', config,
                     '--cache-dir', str(tmp_path / 'kernels')])
    printed = capsys.readouterr().out
    for batch in (1, 2, 4, 8):
        assert 'batch {:3d}: ran in'.format(batch) in printed
    assert 'batch  16' not in printed
    assert 'the CUDA kernels are not built' in printed
    (detector,) = seen
    assert detector.config.nms_mode == 'exact'
    assert detector.config.active_labels == (1, 3)       # person, car
    assert detector.device == torch.device('cpu')
    assert 'WATSOR_KERNEL_CACHE_DIR' not in os.environ
    # without a config: every bucket asked for
    _, buckets = warmup.serving_spec(argparse.Namespace(
        config=None, batches=[4, 1, 2]))
    assert buckets == [1, 2, 4]


@pytest.mark.parametrize('precision,env,dtype', [
    (None, None, torch.bfloat16), ('32', None, torch.float32),
    (None, '32', torch.float32), ('16', '32', torch.bfloat16)])
def test_warmup_precision(tiny_model, monkeypatch, capsys, precision, env,
                          dtype):
    """-p 16|32, and TRT_FLOAT_PRECISION where -p is not given."""
    if env:
        monkeypatch.setenv('TRT_FLOAT_PRECISION', env)
    seen = []
    build = port_main.TorchApplication._detector_factory

    def spy(app, config, precision=None):
        seen.append(precision)
        return build(app, config, precision)

    monkeypatch.setattr(port_main.TorchApplication, '_detector_factory', spy)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        warmup.main(['-m', tiny_model, '-b', '1'] +
                    (['-p', precision] if precision else []))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert seen == [{torch.float32: '32', torch.bfloat16: '16'}[dtype]]
    assert 'batch   1: ran in' in capsys.readouterr().out


def test_warmup_needs_a_card_unless_the_cpu_is_asked_for(tiny_model,
                                                         monkeypatch):
    monkeypatch.delenv('WATSOR_DEVICE_POOL')
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is visible')
    with pytest.raises(RuntimeError, match='No CUDA device'):
        warmup.main(['-m', tiny_model, '-b', '1'])


# ---- the engine shim ------------------------------------------------------

@pytest.fixture
def warmup_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(warmup, 'main', lambda argv: calls.append(list(argv)))
    return calls


def _opt(argv, flag):
    return argv[argv.index(flag) + 1]


def test_engine_maps_trt_flags_to_the_warmup(warmup_calls, tmp_path):
    """The reference's invocation: -i model file, -o engine FILE (its
    parent becomes the kernel build directory), -p precision."""
    engine.main(['-i', 'detector.uff', '-o', str(tmp_path / 'gpu.trt'),
                 '-p', '32'])
    (argv,) = warmup_calls
    assert _opt(argv, '--cache-dir') == str(tmp_path)
    assert _opt(argv, '-p') == '32'
    # 'detector' is not a zoo name: a weight file, whose directory becomes
    # the model dir
    assert _opt(argv, '--model-path') == os.getcwd()


def test_engine_zoo_stem_selects_the_model(warmup_calls, tmp_path,
                                           monkeypatch):
    monkeypatch.delenv('WATSOR_KERNEL_CACHE_DIR', raising=False)
    name = sorted(zoo.MODEL_REGISTRY)[0]
    engine.main(['-i', name + '.tflite', '-o', str(tmp_path / 'out')])
    engine.main(['-w', '2048', '-mw', '300', '-mh', '300'])
    first, second = warmup_calls
    assert _opt(first, '-m') == name and _opt(first, '-p') == '16'
    assert _opt(first, '--cache-dir') == str(tmp_path / 'out')
    # the ignored reference flags are accepted; the default directory
    assert second == ['-p', '16']


# ---- the launcher ---------------------------------------------------------

class _StubApp:
    instances = []

    def __init__(self, args):
        self.args = args
        self.ran = False
        _StubApp.instances.append(self)

    def run(self):
        self.ran = True


@pytest.fixture
def launcher(monkeypatch, tmp_path):
    monkeypatch.setattr(port_main, 'TorchApplication', _StubApp)
    _StubApp.instances = []
    config = tmp_path / 'config.yaml'
    config.write_text('cameras: []\n')
    return str(config)


def test_main_for_gpu_warms_the_serving_detector_then_serves(
        launcher, warmup_calls, tmp_path):
    main_for_gpu.main(['-c', launcher, '--model', 'ssd_mobilenet_v1',
                       '--model-path', str(tmp_path)])
    (argv,) = warmup_calls
    assert _opt(argv, '-c') == launcher
    assert _opt(argv, '-m') == 'ssd_mobilenet_v1'
    assert _opt(argv, '--model-path') == str(tmp_path)
    (app,) = _StubApp.instances
    assert app.ran and app.args.config == launcher


def test_main_for_gpu_serves_when_the_warmup_fails(launcher, monkeypatch,
                                                   caplog):
    def boom(argv):
        raise RuntimeError('nvcc not found')
    monkeypatch.setattr(warmup, 'main', boom)
    monkeypatch.delenv('WATSOR_MODEL', raising=False)
    main_for_gpu.main(['-c', launcher])
    (app,) = _StubApp.instances
    assert app.ran
    assert 'Warmup failed' in caplog.text and 'nvcc not found' in caplog.text
