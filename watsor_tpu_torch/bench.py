"""The port's measurement entry points: the counterpart of the repo-root
``bench.py`` (``step``), ``scripts/run_baseline5.py`` (``app``),
``scripts/latency_sweep.py`` (``sweep``) and the other measurement scripts
of ``scripts/``, whose legs live in ``watsor_tpu_torch/measure/``.

    python -m watsor_tpu_torch.bench step    [--device DEV]
    python -m watsor_tpu_torch.bench app     [--device DEV] [--nms MODE]
    python -m watsor_tpu_torch.bench sweep   [--device DEV]
    python -m watsor_tpu_torch.bench host    [--device DEV]   host_budget.py
    python -m watsor_tpu_torch.bench nms     [--device DEV]   the NMS modes
    python -m watsor_tpu_torch.bench int8    [--device DEV]   bench_int8_full.py
    python -m watsor_tpu_torch.bench overlap [--device DEV]   measure_overlap.py
    python -m watsor_tpu_torch.bench models  [--device DEV] [NAME ...]
    python -m watsor_tpu_torch.bench overlay [--device DEV] [BATCH H W]
    python -m watsor_tpu_torch.bench restart [--device DEV]   warm_restart.py
    python -m watsor_tpu_torch.bench lite4   [--device DEV] [PART ...]

``nms`` ports measure_nms_modes.py, validate_nms_modes.py and
measure_nms_active.py; ``models`` roofline.py and validate_timing.py;
``lite4`` profile_lite4.py, profile_lite4_sections.py and
profile_backbone_stages.py (its parts: ``full``, ``forward``, ``post``,
``pre``, ``backbone``, ``fpn``, ``heads``, ``stages``; none: all eight);
each of the last eight is documented in its module under ``measure/``.

Each subcommand prints one JSON line as the last line of its standard
output and its progress on standard error. It reads the environment
variables of the script it ports, under the same names. ``--device``
defaults to the current CUDA device; ``cpu`` runs on the CPU (the tests).
bench.py's ``BENCH_PROBE_TIMEOUT`` (a deadline for the TPU runtime's
device probe) has no counterpart: ``torch.cuda.is_available()`` answers
at once.
Without a card and without ``--device cpu`` a subcommand prints bench.py's
error record (``value`` 0 and ``error``) and exits 1; it never carries on
on the CPU. No subcommand writes into the repository or the working
directory: each writes its line to its script's variable (``BASELINE5_OUT``,
``SWEEP_OUT``, ``HOST_BUDGET_OUT``, ``NMS_OUT``, ``INT8_FULL_OUT``,
``OVERLAP_RESULTS``, ``ROOFLINE_OUT`` and ``VALIDATE_OUT``,
``WARM_RESTART_OUT``, ``PROFILE_OUT``) only where that is set.

``step`` (bench.py): ``build_detector(SSDConfig())`` (ssd_mobilenet_v2 at
300x300, bf16, ``nms: fused``) at ``BENCH_BATCH`` (32) frames. ``value``
is the device-resident rate: ``BENCH_STEPS`` (30) steps dispatched back to
back over four rotating device buffers and one synchronise, the median of
``BENCH_REPS`` (3) runs with its ``{median, min, max, n}`` spread. Beside
it: the p50 of 10 blocking steps; ``e2e_h2d_fps``, 5 steps each fed from
host frames (bench.py's ``e2e_tunnel_fps``: the card sits on PCIe, there
is no tunnel); ``e2e_pipelined_fps``, TorchDetectorBackend's
double-buffered dispatch/resolve; ``h2d_ms``, one batch's copy;
``chained_fps``, the step captured once as a CUDA graph by
``timing.chained_model_runner``; ``device_path``,
``timing.measure_production_device_path`` at the batch, measured in this
run (the production ``fused_exact`` path at 1080p, so kernel 1 runs); and
the roofline row of ``roofline.step_cost`` on the step at the
device-resident rate. bench.py's ``BENCH_CHAINED`` and
``BENCH_DEVICE_PATH`` have no counterpart: both legs always run (bench.py
could skip a compile of minutes, or read a stored record; here each leg
takes seconds), and a failed one fails the run. ``vs_baseline`` is
against the reference's 120 frames/s on one accelerator (its README).

``app`` (run_baseline5.py): TorchApplication with ``BASELINE5_CAMERAS``
(32) ``synthetic://loop`` cameras of 1920x1080, the two-zone mask on each,
person and car filters and an MPEG-TS encoder on ``cam00``, with
``WATSOR_DEVICE_RENDER=1`` unless set. The decoders run at 1 frame/s
until the first inference (within ``BASELINE5_WARM_DEADLINE``, 900 s),
then at ``BASELINE5_CAP`` frames/s a camera (0: 30); ``/metrics`` is
sampled every 10 s for ``BASELINE5_DURATION`` (90 s) and the second half
averaged. The path follows the service's own knobs (``WATSOR_FUSED_BLOCKS``,
``WATSOR_QUANTIZE``, ``WATSOR_INT8_POINTWISE``) and ``--nms``, which writes
the config's ``nms:`` key. Where the native video library cannot load (no
libav), ``encoder_fps`` is null and ``notes`` says why.

``sweep`` (latency_sweep.py): TorchApplication with ``SWEEP_CAMERAS`` (4)
cameras of ``SWEEP_WIDTH`` x ``SWEEP_HEIGHT`` (1920x1080), ``SWEEP_MODEL``
(ssd_mobilenet_v2), ``WATSOR_MIN_BUCKET`` pinned to the cameras' bucket,
decoders capped at ``SWEEP_CAP`` (10) frames/s; 15 s of refill, then
``SWEEP_DURATION`` (60 s) of samples. On the card it then probes the link:
the median round trip of a 4-byte copy in and a scalar fetch (20 tries),
and the best H2D rate of one [bucket, 300, 300, 3] uint8 batch (5 tries).
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from time import perf_counter

import numpy as np
import torch

from watsor_tpu_torch.measure import scoped_environ, sync, write_out
from watsor_tpu_torch.workload import card_label

BASELINE_FPS = 120.0  # the reference's single-accelerator throughput
ROOFLINE_KEYS = ('gflops_per_frame', 'achieved_tflops', 'pct_peak_flops',
                 'hbm_mb_per_frame', 'achieved_gbps', 'pct_peak_bw',
                 'arithmetic_intensity', 'bound', 'pct_speed_of_light')
DEVICE_PATH_KEYS = ('fps', 'ms_per_step', 'batch', 'vs_north_star')
SAMPLE_PERIOD_S = 10.0
SWEEP_REFILL_S = 15.0
METRICS = {'step': 'ssd_mobilenet_v2_300 fused detect step',
           'app': 'BASELINE config #5 (real application)',
           'sweep': 'latency_sweep',
           'host': 'host budget',
           'nms': 'nms modes',
           'int8': 'int8_full step vs bf16',
           'overlap': 'transfer/compute overlap, SSD300 fused step',
           'models': 'roofline and chained timing of the zoo',
           'overlay': 'device overlay render',
           'restart': 'warm restart',
           'lite4': 'EfficientDet-Lite step by stage, forward by section, '
                    'backbone by stage group'}


class BenchError(RuntimeError):
    """A leg that did not produce its number."""


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _env(name, default, kind=float):
    return kind(os.environ.get(name) or default)


# copied from bench.py:47-55
def _reps(fn, n):
    """Run a timed experiment ``n`` times; return (median, spread-dict)."""
    vals = [float(fn()) for _ in range(n)]
    med = float(np.median(vals))
    return med, {"median": round(med, 1), "min": round(min(vals), 1),
                 "max": round(max(vals), 1), "n": n}


# -- step (bench.py) ---------------------------------------------------------

def run_step(device, log=_log):
    """bench.py's record for the port's detect step on ``device``."""
    from watsor_tpu_torch import roofline, timing
    from watsor_tpu_torch.detection.backend import TorchDetectorBackend
    from watsor_tpu_torch.models.ssd import SSDConfig, build_detector

    batch = _env('BENCH_BATCH', 32, int)
    measure_steps = _env('BENCH_STEPS', 30, int)
    reps = max(1, _env('BENCH_REPS', 3, int))
    detector = build_detector(SSDConfig(), device=device)
    step = detector.detect_batch

    rng = np.random.RandomState(0)
    host_frames = rng.randint(0, 255, (batch, 300, 300, 3), np.uint8)
    buffers = [torch.from_numpy(
        rng.randint(0, 255, (batch, 300, 300, 3), np.uint8)).to(device)
        for _ in range(4)]

    log('bench: batch-{} step on {}'.format(batch, device))
    t0 = perf_counter()
    step(buffers[0])
    sync(device)
    log('bench: warm in {:.1f}s'.format(perf_counter() - t0))

    def device_leg():
        t0 = perf_counter()
        for i in range(measure_steps):
            step(buffers[i % 4])
        sync(device)
        return batch * measure_steps / (perf_counter() - t0)

    device_fps, device_spread = _reps(device_leg, reps)

    lat = []
    for i in range(10):
        t1 = perf_counter()
        step(buffers[i % 4])
        sync(device)
        lat.append((perf_counter() - t1) * 1000.0)
    p50_ms = float(np.percentile(lat, 50))

    def h2d_leg():
        t0 = perf_counter()
        for _ in range(5):
            step(torch.from_numpy(host_frames).to(device))
        sync(device)
        return batch * 5 / (perf_counter() - t0)

    h2d_fps, h2d_spread = _reps(h2d_leg, reps)

    # double-buffered dispatch/resolve, the detector task's pattern
    backend = TorchDetectorBackend(detector, device, max_batch=batch)
    staging = [host_frames.copy(), host_frames.copy()]
    backend.detect_batch(staging[0])
    steps = 10

    def pipelined_leg():
        t0 = perf_counter()
        inflight = None
        for i in range(steps):
            handle = backend.dispatch(staging[i % 2])
            if inflight is not None:
                backend.resolve(inflight)
            inflight = handle
        backend.resolve(inflight)
        return batch * steps / (perf_counter() - t0)

    pipelined_fps, pipelined_spread = _reps(pipelined_leg, reps)
    t0 = perf_counter()
    torch.from_numpy(host_frames).to(device)
    sync(device)
    h2d_ms = (perf_counter() - t0) * 1000.0

    result = {
        "metric": "ssd_mobilenet_v2_300 fused detect step (forward+decode+"
                  "NMS), batch %d, 1 card, device-resident" % batch,
        "value": round(device_fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(device_fps / BASELINE_FPS, 2),
        "p50_step_latency_ms": round(p50_ms, 2),
        "e2e_h2d_fps": round(h2d_fps, 1),
        "e2e_pipelined_fps": round(pipelined_fps, 1),
        "h2d_ms": round(h2d_ms, 1),
        "spread": {"value": device_spread, "e2e_h2d_fps": h2d_spread,
                   "e2e_pipelined_fps": pipelined_spread},
        "device": card_label(device),
    }

    log('bench: chained cross-check (one captured step)')
    chained_ms, _ = timing.chained_step_ms(timing.chained_model_runner(
        lambda _, x: step(x), None, batch, 300, device=device))
    result['chained_ms_per_step'] = round(chained_ms, 2)
    result['chained_fps'] = round(batch * 1000.0 / chained_ms, 1)

    log('bench: full device path')
    record = timing.measure_production_device_path(
        batch=batch, log=log, device=device)
    result['device_path'] = {k: record[k] for k in DEVICE_PATH_KEYS}
    result['device_path']['source'] = 'measured this run'

    flops, nbytes = roofline.step_cost(
        step, buffers[0], params=list(detector.model.state_dict().values()))
    if flops or nbytes:
        row = roofline.roofline_row('ssd_mobilenet_v2', batch,
                                    batch * 1000.0 / device_fps, flops,
                                    nbytes, device)
        result.update((k, row[k]) for k in ROOFLINE_KEYS if k in row)
    return result


# -- app and sweep: the application under load --------------------------------

# copied from scripts/run_baseline5.py:40-50; the two zones' corners are
# scaled from 1920x1080 to the frame (the same pixels at 1920x1080)
def make_mask(path, w=1920, h=1080):
    import cv2
    rgba = np.zeros((h, w, 4), np.uint8)
    scale = np.array([w / 1920.0, h / 1080.0])

    def corners(points):
        return np.round(np.array(points) * scale).astype(np.int32)

    cv2.fillPoly(rgba, [corners([[200, 400], [900, 400],
                                 [1100, 1060], [100, 1060]])],
                 (90, 140, 90, 255))
    cv2.fillPoly(rgba, [corners([[1300, 500], [1860, 500],
                                 [1860, 1060], [1300, 1060]])],
                 (140, 90, 90, 255))
    cv2.imwrite(path, rgba)


# copied from scripts/run_baseline5.py:53-78; ``nms`` adds the config's
# top-level ``nms:`` key, ``frame_hw`` sizes the cameras
def make_config(path, mask_path, cameras, port, nms=None,
                frame_hw=(1080, 1920)):
    entries = []
    for i in range(cameras):
        if i == 0:
            enc = ('      ffmpeg:\n'
                   '        decoder: [-i, -f, rawvideo, -pix_fmt, rgb24]\n'
                   '        encoder: [-f, rawvideo, -pix_fmt, rgb24, -i,'
                   ' -f, mpegts, -vcodec, libx264]\n')
        else:
            enc = ('      ffmpeg:\n'
                   '        decoder: [-i, -f, rawvideo, -pix_fmt, rgb24]\n')
        entries.append(
            '  - cam{i:02d}:\n'
            '      width: {w}\n'
            '      height: {h}\n'
            '      input: synthetic://loop\n'
            '      mask: {mask}\n'
            '{enc}'
            '      detect:\n'
            '        - person: {{confidence: 10, area: 1}}\n'
            '        - car: {{confidence: 10, area: 1, zones: [1, 2]}}\n'
            .format(i=i, w=frame_hw[1], h=frame_hw[0], mask=mask_path,
                    enc=enc))
    with open(path, 'w') as f:
        f.write('http:\n  port: {}\n{}cameras:\n{}'.format(
            port, 'nms: {}\n'.format(nms) if nms else '',
            ''.join(entries)))


# copied from scripts/latency_sweep.py:47-64
def make_sweep_config(path, cameras, port, width, height):
    entries = []
    for i in range(cameras):
        entries.append(
            '  - cam{i:02d}:\n'
            '      width: {w}\n'
            '      height: {h}\n'
            '      input: synthetic://loop\n'
            '      ffmpeg:\n'
            '        decoder: [-i, -f, rawvideo, -pix_fmt, rgb24]\n'
            '      detect:\n'
            '        - person: {{confidence: 10, area: 1}}\n'
            '        - car: {{confidence: 10, area: 1}}\n'
            .format(i=i, w=width, h=height))
    with open(path, 'w') as f:
        f.write('http:\n  port: {}\ncameras:\n{}'.format(
            port, ''.join(entries)))


def get_metrics(port):
    url = 'http://127.0.0.1:{}/metrics'.format(port)
    with urllib.request.urlopen(url, timeout=10) as response:
        return json.loads(response.read())


# copied from scripts/run_baseline5.py:87-107
def aggregate(metrics):
    cams = metrics['cameras']
    agg = {
        'decoder_fps_total': round(sum(
            c['fps']['decoder'] for c in cams), 1),
        'sieve_fps_total': round(sum(
            c['fps']['sieve'] for c in cams), 1),
        'snapshot_fps_total': round(sum(
            c['fps']['snapshot'] for c in cams), 1),
        'encoder_fps': next((c['fps']['encoder'] for c in cams
                             if 'encoder' in c['fps']), None),
        'buffer_in_mean_pct': round(sum(
            c['buffer_in'] for c in cams) / len(cams), 1),
        'detectors': metrics['detectors'],
        'e2e_latency_ms_p50': max(
            (c.get('latency_ms_p50') or 0) for c in cams),
    }
    return agg


# copied from scripts/latency_sweep.py:73-92
def sample(metrics):
    cams = metrics['cameras']
    det = metrics['detectors'][0]
    return {
        'decoder_fps_total': round(sum(
            c['fps']['decoder'] for c in cams), 1),
        'sieve_fps_total': round(sum(
            c['fps']['sieve'] for c in cams), 1),
        'detector_fps': det['fps'],
        'inference_ms': det.get('inference_time'),
        'detector_p50': det.get('latency_ms_p50'),
        'detector_p95': det.get('latency_ms_p95'),
        'sieve_p50': max((c.get('latency_ms_p50') or 0) for c in cams),
        'sieve_p95': max((c['latency_ms']['sieve'].get('p95') or 0)
                         for c in cams),
    }


def _device_pool(device):
    """WATSOR_DEVICE_POOL for one detector on ``device``: the first card
    (the pool counts cards from the first) or the CPU."""
    if device.type == 'cpu':
        return 'cpu:1'
    if (device.index or 0) != 0:
        raise BenchError('app and sweep run on the first card or the CPU, '
                         'not {}'.format(device))
    return 'cuda:1'


def drive_application(argv, port, rate, duration, summarize, refill_s=0.0,
                      warm_deadline=900.0, log=_log):
    """Run TorchApplication (``argv``: its command line) in a thread:
    decoders paced at 1 frame/s until ``/metrics`` shows the first
    inference within ``warm_deadline``, then at ``rate`` frames/s a camera
    (0: unpaced); after ``refill_s``, ``summarize(/metrics)`` every
    SAMPLE_PERIOD_S for ``duration`` s. Stops the application and returns
    the samples. The pace is set again at every sample: a loop decoder
    still drawing its frames when the first pace was set restores its old
    period afterwards (io/synthetic.py ``_prerender``)."""
    from watsor_tpu_torch.main import (TorchApplication,
                                       _parse_commandline_arguments)
    app = TorchApplication(_parse_commandline_arguments(argv))
    thread = threading.Thread(target=app.run, daemon=True)
    thread.start()

    def pace(fps):
        # the synthetic decoder's own frame period (the MQTT rate limiter
        # would be lifted by the sieve on every random-weight detection)
        for camera in app._cameras:
            if hasattr(camera.decoder, '_period'):
                camera.decoder._period = (1.0 / fps) if fps > 0 else 0.0

    try:
        deadline = time.time() + warm_deadline
        log('bench: cameras paced at 1 frame/s for the warmup; waiting for '
            'the first inference')
        while True:
            if not thread.is_alive():
                raise BenchError('the application stopped')
            pace(1)
            try:
                m = get_metrics(port)
                if m['detectors'] and m['detectors'][0]['fps'] > 0:
                    break
            except (OSError, ValueError, KeyError):
                pass
            if time.time() > deadline:
                raise BenchError('no inference within {} s'.format(
                    warm_deadline))
            time.sleep(1.0)
        pace(rate)
        time.sleep(refill_s)
        log('bench: warm; sampling for {}s at {} frames/s a camera'.format(
            duration, rate or 'unpaced'))
        samples = []
        t_end = time.time() + duration
        while time.time() < t_end:
            time.sleep(SAMPLE_PERIOD_S)
            pace(rate)
            try:
                samples.append(summarize(get_metrics(port)))
            except (OSError, ValueError, KeyError, IndexError) as exc:
                log('bench: sample failed: {}'.format(exc))
                continue
            log('bench: sample {}'.format(json.dumps(samples[-1])))
    finally:
        app._stop_main.set()
        thread.join(60)
    if thread.is_alive():
        raise BenchError('the application did not stop')
    if not samples:
        raise BenchError('no sample of /metrics')
    return samples


def _mean(values):
    values = [v for v in values if v is not None]
    return round(sum(values) / len(values), 1) if values else None


def run_app(device, nms=None, frame_hw=(1080, 1920), log=_log,
            summarize=aggregate):
    """run_baseline5.py's record for TorchApplication on ``device``;
    ``summarize`` turns each /metrics sample into ``aggregate``'s dict
    (``profile_step --path app`` times its windows there)."""
    from watsor_tpu_torch.io import native

    cameras = _env('BASELINE5_CAMERAS', 32, int)
    duration = _env('BASELINE5_DURATION', 90)
    port = _env('BASELINE5_PORT', 18580, int)
    cap = _env('BASELINE5_CAP', 0)
    path = {k: os.environ.get(k) for k in (
        'WATSOR_FUSED_BLOCKS', 'WATSOR_QUANTIZE', 'WATSOR_INT8_POINTWISE')}
    path['nms'] = nms
    with tempfile.TemporaryDirectory(prefix='watsor-bench-') as workdir:
        mask_path = os.path.join(workdir, 'mask.png')
        config_path = os.path.join(workdir, 'config.yaml')
        make_mask(mask_path, w=frame_hw[1], h=frame_hw[0])
        make_config(config_path, mask_path, cameras, port, nms=nms,
                    frame_hw=frame_hw)
        env = {'WATSOR_DEVICE_POOL': _device_pool(device),
               'WATSOR_DEVICE_RENDER':
               os.environ.get('WATSOR_DEVICE_RENDER', '1')}
        with scoped_environ(env):
            samples = drive_application(
                ['-c', config_path, '-m', os.path.join(workdir, 'none')],
                port, cap if cap > 0 else 30, duration, summarize,
                warm_deadline=_env('BASELINE5_WARM_DEADLINE', 900), log=log)
    steady = samples[len(samples) // 2:]

    def mean(key, sub=None):
        return _mean([s[key] if sub is None else s[key][0][sub]
                      for s in steady])

    notes = []
    encoder_fps = mean('encoder_fps')
    if not native.available():
        encoder_fps = None
        notes.append('cam00 encoder: the native video library did not load '
                     '(no libav on this machine), so nothing was encoded')
    result = {
        'experiment': 'BASELINE config #5: {} x {}p full pipeline, one '
                      'card, real TorchApplication'.format(cameras,
                                                           frame_hw[0]),
        'cameras': cameras,
        'decoder_fps_total': mean('decoder_fps_total'),
        'sieve_fps_total': mean('sieve_fps_total'),
        'snapshot_fps_total': mean('snapshot_fps_total'),
        'encoder_fps': encoder_fps,
        'detector_fps': mean('detectors', 'fps'),
        'detector_inference_ms': mean('detectors', 'inference_time'),
        'latency_ms_p50': mean('detectors', 'latency_ms_p50'),
        'latency_ms_p95': mean('detectors', 'latency_ms_p95'),
        'buffer_in_mean_pct': mean('buffer_in_mean_pct'),
        'cap_fps_per_camera': cap or None,
        'samples': samples,
        'environment': {'host_cores': os.cpu_count(),
                        'device': card_label(device)},
        'path': path,
        'notes': notes,
    }
    if not result['detector_fps']:
        raise BenchError('the detector served 0 frames/s: {}'.format(
            json.dumps(result)))
    write_out('BASELINE5_OUT', result, 'w')
    return result


def probe_link(bucket, device):
    """The round trip of a 4-byte copy to ``device`` and a scalar fetch
    (median of 20), and the best H2D rate of one [bucket, 300, 300, 3]
    uint8 batch (of 5), each copy finished by a synchronise and a fetch of
    one element."""
    tiny = torch.zeros((1,), dtype=torch.float32)
    rtts = []
    for _ in range(20):
        t0 = perf_counter()
        float(tiny.to(device)[0])
        rtts.append((perf_counter() - t0) * 1000.0)
    rtts.sort()
    payload = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (bucket, 300, 300, 3), np.uint8))
    rates = []
    for i in range(5):
        payload[0, 0, 0, 0] = i
        t0 = perf_counter()
        x = payload.to(device)
        sync(device)
        int(x[0, 0, 0, 0])
        rates.append(payload.nbytes / (perf_counter() - t0) / 1e6)
    return {
        'rtt_ms_median': round(rtts[len(rtts) // 2], 4),
        'h2d_mb_s_best': round(max(rates), 1),
        'h2d_payload_mb': round(payload.nbytes / 1e6, 2),
    }


def run_sweep(device, log=_log):
    """latency_sweep.py's record for TorchApplication on ``device``."""
    from watsor_tpu_torch.detection.backend import _bucket

    cameras = _env('SWEEP_CAMERAS', 4, int)
    width = _env('SWEEP_WIDTH', 1920, int)
    height = _env('SWEEP_HEIGHT', 1080, int)
    model = os.environ.get('SWEEP_MODEL') or 'ssd_mobilenet_v2'
    cap = _env('SWEEP_CAP', 10)
    duration = _env('SWEEP_DURATION', 60)
    port = _env('SWEEP_PORT', 18581, int)
    bucket = _bucket(cameras)
    with tempfile.TemporaryDirectory(prefix='watsor-sweep-') as workdir:
        config_path = os.path.join(workdir, 'config.yaml')
        make_sweep_config(config_path, cameras, port, width, height)
        env = {'WATSOR_DEVICE_POOL': _device_pool(device),
               'WATSOR_MIN_BUCKET': str(bucket)}
        log('bench: sweep at {} cameras (one bucket: {})'.format(cameras,
                                                                 bucket))
        with scoped_environ(env):
            samples = drive_application(
                ['-c', config_path, '-m', os.path.join(workdir, 'none'),
                 '--model', model], port, cap, duration, sample,
                refill_s=SWEEP_REFILL_S,
                warm_deadline=_env('SWEEP_WARM_DEADLINE', 900), log=log)
    steady = samples[len(samples) // 2:]

    def mean(key):
        return _mean([s[key] for s in steady])

    row = {
        'experiment': 'latency_sweep',
        'cameras': cameras,
        'resolution': '{}x{}'.format(width, height),
        'model': model,
        'platform': device.type,
        'bucket': bucket,
        'cap_fps_per_camera': cap,
        'detector_latency_ms_p50': mean('detector_p50'),
        'detector_latency_ms_p95': mean('detector_p95'),
        'sieve_e2e_ms_p50': mean('sieve_p50'),
        'sieve_e2e_ms_p95': mean('sieve_p95'),
        'detector_fps': mean('detector_fps'),
        'inference_ms_per_frame': mean('inference_ms'),
        'decoder_fps_total': mean('decoder_fps_total'),
        'link': probe_link(bucket, device) if device.type == 'cuda'
        else None,
        'host_cores': os.cpu_count(),
        'device': card_label(device),
        'ts': time.strftime('%Y-%m-%dT%H:%M:%S'),
    }
    write_out('SWEEP_OUT', row, 'a')
    return row


def error_record(command, error):
    """bench.py's record of a run that produced no number."""
    return {'metric': METRICS[command], 'value': 0, 'unit': 'frames/s',
            'vs_baseline': 0, 'error': error}


def run_command(command, device, args):
    """The record of ``command`` on ``device``."""
    from watsor_tpu_torch.measure import (host_budget, int8_full, lite4,
                                          nms_modes, overlap, overlay,
                                          roofline_table, warm_restart)
    legs = {
        'step': lambda: run_step(device),
        'app': lambda: run_app(device, nms=args.nms),
        'sweep': lambda: run_sweep(device),
        'host': lambda: host_budget.measure(device, log=_log),
        'nms': lambda: nms_modes.measure(device, log=_log),
        'int8': lambda: int8_full.measure(device, log=_log),
        'overlap': lambda: overlap.measure(device, log=_log),
        'models': lambda: roofline_table.measure(
            device, names=args.operands, log=_log),
        'overlay': lambda: overlay.measure(
            device, *(int(v) for v in args.operands), log=_log),
        'restart': lambda: warm_restart.measure(device, log=_log),
        'lite4': lambda: lite4.measure(device, parts=args.operands,
                                       log=_log)}
    return legs[command]()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m watsor_tpu_torch.bench',
        description='The detect-step bench, the application under the '
                    'north-star load and the measurement legs of scripts/, '
                    'one JSON line each.')
    parser.add_argument('command', choices=tuple(METRICS))
    parser.add_argument('operands', nargs='*',
                        help='models: zoo names; overlay: batch, height, '
                             'width; lite4: parts')
    parser.add_argument('--device', default=None,
                        help="the device (default: the current CUDA device; "
                             "'cpu' for the CPU)")
    parser.add_argument('--nms', default=None,
                        choices=('fused_exact', 'fused', 'exact'),
                        help='app: the config\'s nms key (default: none, '
                             'the service\'s fused_exact)')
    args = parser.parse_args(argv)
    if args.nms and args.command != 'app':
        parser.error('--nms applies to app only')
    if args.operands and args.command not in ('models', 'overlay', 'lite4'):
        parser.error('operands apply to models, overlay and lite4 only')
    if args.command == 'overlay' and len(args.operands) > 3:
        parser.error('overlay takes at most batch, height and width')
    if args.command == 'lite4':
        from watsor_tpu_torch.measure.lite4 import PARTS
        unknown = [p for p in args.operands if p not in PARTS]
        if unknown:
            parser.error('lite4 parts are {}, not {}'.format(
                ', '.join(PARTS), ', '.join(unknown)))
    if args.device is None and not torch.cuda.is_available():
        print(json.dumps(error_record(
            args.command, 'no CUDA device is visible (pass --device cpu to '
            'run on the CPU)')), flush=True)
        return 1
    from watsor_tpu_torch.models.ssd import resolve_device
    # the restart leg's parent makes no CUDA call: its children meet the
    # card fresh
    device = torch.device(args.device or 'cuda') \
        if args.command == 'restart' else resolve_device(args.device)
    try:
        result = run_command(args.command, device, args)
    except Exception as exc:
        # a failed leg fails the run, with its record as the last line
        traceback.print_exc()
        print(json.dumps(error_record(args.command, repr(exc))), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
