"""The port's composition root: ``TorchApplication``, the HTTP API and
the CLI.

    python -m watsor_tpu_torch.main -c config/config.yaml [--model NAME]

Copied from watsor_tpu/main.py (``Application``,
``_parse_commandline_arguments``, the HTTP routes and the lifecycle), with
its JAX branches replaced by the PyTorch detection path: the detector
build, the device pool, the profiler route (torch.profiler) and ``run``
without the platform pin and discovery probe; ``--check-config`` as the
JAX package's, over the port's modules. The host graph is the port's own
copy of the JAX package's (decoders, balanced queue, sieve, effects,
snapshot, MQTT, HTTP). Every model of the JAX package's zoo is served (``model:``
in the config or ``--model``). Knobs honoured as in the JAX package:
``TRT_FLOAT_PRECISION=32|16``, ``WATSOR_FUSED_BLOCKS=1`` (plain
ssd_mobilenet_v2 only), ``WATSOR_QUANTIZE=int8`` (the ``ssd_`` models) or
``int8_full`` (plain ssd_mobilenet_v2 only; with ``WATSOR_CALIB_FILE`` and
``WATSOR_INT8_POINTWISE=conv|dot|pallas``), ``WATSOR_FUSED_HEADS=1``
(EfficientDet), ``WATSOR_DEVICE_FILTERS=0``, ``WATSOR_DEVICE_POOL``,
``WATSOR_FLEET=1`` (one detector, ``detector-fleet``, whose batch of up to
64 frames is split over every device of the pool: parallel/) and
``WATSOR_DEVICE_RENDER=0|1`` (box borders drawn on the device for every
camera without a zone mask, batched across cameras: output/device_render.py;
on by default under the fleet, off otherwise).
"""

import argparse
import base64
import hmac
import json
import logging
import os
import signal
import socket
import threading
from collections import namedtuple
from queue import Queue

import torch

from watsor_tpu_torch.config import parse, validate, normalize
from watsor_tpu_torch.config.coco import coco_label_index
from watsor_tpu_torch.runtime.frames import FrameBuffer
from watsor_tpu_torch.runtime.channel import balanced_queue_group
from watsor_tpu_torch.runtime.logs import init_logging
from watsor_tpu_torch.runtime.meters import RateLimiter
from watsor_tpu_torch.runtime.watchdog import WatchDog

_LOGGER = logging.getLogger('watsor_tpu_torch.main')

Camera = namedtuple('Camera', [
    'name', 'config', 'buffer_in', 'buffer_out', 'decoder', 'sieve',
    'visual_effects', 'encoder', 'snapshot', 'mqtt', 'rate_limiter'])


def _parse_commandline_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description='watsor-tpu: TPU-native object detection for video '
                    'surveillance')
    parser.add_argument('-c', '--config', required=True,
                        help='configuration YAML file')
    parser.add_argument('-m', '--model-path', default=os.environ.get(
        'MODEL_PATH', '/usr/share/watsor/model'),
        help='directory with detection model weights')
    parser.add_argument('--model', default=os.environ.get('WATSOR_MODEL'),
                        help='detection model from the zoo '
                             '(ssd_mobilenet_v2, efficientdet_lite0, ...)')
    parser.add_argument('--log-path', default=os.environ.get('LOG_PATH'),
                        help='directory for rotated log files')
    parser.add_argument('--log-level',
                        default=os.environ.get('LOG_LEVEL', 'INFO'),
                        help='logging level')
    parser.add_argument('--check-config', action='store_true',
                        help='validate the configuration (schema, secrets, '
                             'masks, model name, decoder argv translation) '
                             'and exit 0/1 without starting — for CI and '
                             'k8s init containers')
    return parser.parse_args(argv)


# copied from watsor_tpu/main.py:70-131 with the port's modules
def check_config(args):
    """Validate everything startup would reject, without starting:
    schema + secrets (config loader), the model name, every camera's
    mask file/alpha channel, and the decoder argv translation (reporting
    which flags would need WATSOR_FFMPEG_FALLBACK=1). Returns the number
    of problems found and prints a human report."""
    problems = []
    try:
        config = normalize(validate(parse(args.config)),
                           os.path.dirname(os.path.abspath(args.config)))
    except Exception as exc:
        print('config: INVALID\n{}'.format(exc))
        return 1
    print('config: schema ok ({} camera(s))'.format(len(config['cameras'])))

    try:
        model_name, watched, nms = detector_spec_from_config(config, args)
        print('model: {} (watched labels: {}, nms: {})'.format(
            model_name, sorted(watched) if watched else 'all',
            nms or 'default'))
    except SystemExit as exc:
        problems.append(str(exc))

    from watsor_tpu_torch.io.video import decoder_args_from_argv
    for camera in config['cameras']:
        name = next(iter(camera))
        camera_config = camera[name]
        mask = camera_config.get('mask')
        if mask:
            try:
                import cv2
                from watsor_tpu_torch.filters.mask import (ZoneMask,
                                                           get_alpha_channel)
                image = cv2.imread(mask, cv2.IMREAD_UNCHANGED)
                if image is None:
                    raise IOError('unreadable mask file {}'.format(mask))
                alpha = get_alpha_channel(image)
                # validate against the CONFIGURED frame size, exactly as
                # TorchApplication._create_filters will (a size mismatch is
                # startup-fatal and must fail the check)
                zones = ZoneMask(alpha, (camera_config['height'],
                                         camera_config['width'])).num_zones
                print('camera {}: mask ok ({} zone(s))'.format(name, zones))
            except Exception as exc:
                problems.append('camera {}: mask: {}'.format(name, exc))
        decoder_argv = camera_config.get('ffmpeg', {}).get('decoder', [])
        try:
            translated = decoder_args_from_argv(decoder_argv)
            if translated.unknown:
                print('camera {}: decoder flags not natively translated: '
                      '{} (needs WATSOR_FFMPEG_FALLBACK=1)'.format(
                          name, ' '.join(translated.unknown)))
            else:
                print('camera {}: decoder argv ok'.format(name))
        except Exception as exc:
            problems.append('camera {}: decoder argv: {}'.format(name, exc))

    for problem in problems:
        print('PROBLEM: {}'.format(problem))
    print('check-config: {}'.format(
        'OK' if not problems else '{} problem(s)'.format(len(problems))))
    return len(problems)


def detector_spec_from_config(config, args):
    """(model_name, watched labels or None, nms mode) for this config. A
    name outside the zoo exits: the registry's names, and
    ``efficientdet_<variant>`` for a published Lite variant."""
    from watsor_tpu_torch.models.zoo import DEFAULT_MODEL, model_config
    model_name = getattr(args, 'model', None) or config.get('model') \
        or DEFAULT_MODEL
    try:
        model_config(model_name)
    except ValueError as exc:
        raise SystemExit(str(exc))
    watched = set()
    for camera in config['cameras']:
        camera_config = camera[next(iter(camera))]
        for entry in camera_config['detect']:
            label = coco_label_index(next(iter(entry)))
            if label:
                watched.add(label)
    return model_name, watched or None, config.get('nms')


def _plain_v2(config):
    """The plain (non-Lite) SSD on MobileNetV2: the one family the fused
    blocks and the int8 walk cover, as in the JAX package."""
    return getattr(config, 'backbone', None) == 'mobilenet_v2' and \
        not config.lite


def use_full_f32():
    """Turn TF32 off for cuDNN's convolutions and cuBLAS's products in this
    process. cuDNN runs f32 convolutions in TF32 by default, which moves an
    f32 detector's raw outputs by about 1e-3 relative on the card
    (chip_smoke.py's TF32 line, PERF.md), over the port's f32 bar of 5e-4;
    TRT_FLOAT_PRECISION=32 asks for full f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _prometheus_metrics(data):
    """Render the /metrics JSON (reference shape) as Prometheus text
    exposition format — a watsor-tpu extension (`?format=prometheus`)
    for scrape-based monitoring; the JSON default stays byte-compatible
    with the reference's consumers (main.py:221-253)."""
    lines = []

    def escape(value):
        # label-value escaping per the exposition format: backslash,
        # double quote, newline
        return str(value).replace('\\', '\\\\').replace('"', '\\"') \
            .replace('\n', '\\n')

    def gauge(name, help_text, samples):
        lines.append('# HELP {} {}'.format(name, help_text))
        lines.append('# TYPE {} gauge'.format(name))
        for labels, value in samples:
            label_str = ','.join('{}="{}"'.format(k, escape(v))
                                 for k, v in labels.items())
            lines.append('{}{{{}}} {}'.format(name, label_str, value))

    cameras = data.get('cameras', [])
    gauge('watsor_camera_fps', 'Frames per second per pipeline stage',
          [({'camera': c['name'], 'stage': stage}, value)
           for c in cameras for stage, value in c['fps'].items()])
    for field, help_text in (('buffer_in', 'Input frame buffer fullness, '
                                           'percent'),
                             ('buffer_out', 'Output frame buffer '
                                            'fullness, percent')):
        gauge('watsor_camera_{}_percent'.format(field), help_text,
              [({'camera': c['name']}, c[field]) for c in cameras])
    gauge('watsor_camera_latency_ms',
          'Frame capture to stage completion latency, milliseconds',
          [({'camera': c['name'], 'stage': stage, 'quantile': q}, value)
           for c in cameras
           for stage, percentiles in c.get('latency_ms', {}).items()
           for q, value in percentiles.items()])

    detectors = data.get('detectors', [])
    gauge('watsor_detector_fps', 'Detector throughput, frames per second',
          [({'detector': d['name']}, d['fps']) for d in detectors])
    gauge('watsor_detector_inference_ms',
          'Inference time per frame, milliseconds',
          [({'detector': d['name']}, d['inference_time'])
           for d in detectors])
    gauge('watsor_detector_latency_ms',
          'Frame capture to detections-in-header latency, milliseconds',
          [({'detector': d['name'], 'quantile': q},
            d['latency_ms_' + q]) for d in detectors
           for q in ('p50', 'p95')])
    return '\n'.join(lines) + '\n'


class TorchApplication:
    """Builds and runs the whole graph from a validated config, with
    detection on the PyTorch path."""

    DETECT_SIZE = 300  # fallback detect-plane size (overridden per model)

    def __init__(self, args=None, backend_factory=None):
        self._args = args or _parse_commandline_arguments()
        self._stop_main = threading.Event()
        self._cameras = []
        self._detectors = []
        self._watchdog = WatchDog()
        self._http_server = None
        self._http_config = {}
        self._jpeg_caches = {}
        self._camera_tables = {}
        self._zone_refiners = {}
        self._mesh = None
        self._device_renderer = None
        self._profiler_lock = threading.Lock()
        # injectable for tests: device -> DetectorBackend (the reference's
        # analog is swapping in the analytic shape detector, SURVEY.md §4)
        self._backend_factory = backend_factory

    # -- construction ------------------------------------------------------

    def _read_config(self):
        config = normalize(validate(parse(self._args.config)),
                           os.path.dirname(os.path.abspath(self._args.config)))
        return config

    @property
    def _device_filters(self):
        """Confidence/area/zone filtering fused into the device step.
        WATSOR_DEVICE_FILTERS=0 reverts to the host cascade (exact
        reference semantics; zones are evaluated at full resolution instead
        of the device's 96x96 grid). Only applies to the PyTorch backend —
        injected test backends always use the host cascade."""
        return os.environ.get('WATSOR_DEVICE_FILTERS', '1') != '0' and \
            self._backend_factory is None

    def _create_filters(self, camera_name, camera_config, rate_limiter):
        from watsor_tpu_torch.filters import (AreaFilter, ConfidenceFilter,
                                              MaskFilter, TrackFilter,
                                              ZoneMask)
        detect_config = camera_config['detect']
        chain = [ConfidenceFilter(detect_config), AreaFilter(detect_config)]
        zone_mask = None
        mask_path = camera_config.get('mask')
        if mask_path:
            import cv2
            from watsor_tpu_torch.filters.mask import get_alpha_channel
            image = cv2.imread(mask_path, cv2.IMREAD_UNCHANGED)
            alpha = get_alpha_channel(image)
            zone_mask = ZoneMask(alpha, (camera_config['height'],
                                         camera_config['width']))
            chain.append(MaskFilter(detect_config, zone_mask))
        if self._device_filters:
            # cascade runs on device inside the detection step; the sieve
            # keeps only the (stateful, host-side) tracker
            chain = []
        track = TrackFilter(chain)
        return track, zone_mask

    def _create_effects(self, zone_mask):
        from watsor_tpu_torch.output.effects import (
            BlendEffect, CopyHeaderEffect, CopyImageEffect, DrawEffect,
            DrawEffectWithContours)
        if zone_mask is not None:
            return [CopyHeaderEffect(), CopyImageEffect(),
                    BlendEffect(zone_mask), DrawEffectWithContours(zone_mask)]
        # device render: on by default under the fleet (many cameras, where
        # drawing each frame with cv2 saturates the host's cores), host
        # drawing otherwise; WATSOR_DEVICE_RENDER=0|1 overrides either way
        device_render = os.environ.get('WATSOR_DEVICE_RENDER')
        if device_render is None:
            device_render = '1' if self._fleet else '0'
        if device_render == '1':
            from watsor_tpu_torch.output.device_render import \
                DeviceDrawEffect
            return [CopyHeaderEffect(), CopyImageEffect(),
                    DeviceDrawEffect(self._renderer())]
        return [CopyHeaderEffect(), CopyImageEffect(), DrawEffect()]

    @property
    def _fleet(self):
        return os.environ.get('WATSOR_FLEET') == '1'

    def _renderer(self):
        """The one DeviceRenderer every camera shares: on the mesh's first
        device under the fleet, else on the device pool's first."""
        if self._device_renderer is None:
            from watsor_tpu_torch.detection import resolve_device_pool
            from watsor_tpu_torch.output.device_render import DeviceRenderer
            device = self._mesh.devices[0] if self._mesh is not None \
                else resolve_device_pool()[0]
            self._device_renderer = DeviceRenderer(device=device)
        return self._device_renderer

    def _create_decoder(self, camera_name, camera_config, frame_queue,
                        buffer_in, rate_limiter):
        url = camera_config['input']
        if url.startswith('synthetic://'):
            from watsor_tpu_torch.io.synthetic import make_synthetic_decoder
            return make_synthetic_decoder(url, camera_name, frame_queue,
                                          buffer_in,
                                          rate_limiter=rate_limiter)
        from watsor_tpu_torch.io.video import (VideoDecoder,
                                               decoder_args_from_argv)
        args = decoder_args_from_argv(camera_config['ffmpeg']['decoder'])
        if args.unknown:
            if os.environ.get('WATSOR_FFMPEG_FALLBACK', '') == '1':
                # compat escape hatch: flags the native translation can't
                # honor run through a REAL ffmpeg subprocess with the
                # user's verbatim argv (the reference's own mechanism,
                # stream/ffmpeg.py:41-42) — any ffmpeg option/device/
                # filter then behaves exactly as upstream
                _LOGGER.warning(
                    'Camera %s: ffmpeg decoder flags not translated by '
                    'the native runtime (%s); WATSOR_FFMPEG_FALLBACK=1 — '
                    'spawning a real ffmpeg subprocess with the verbatim '
                    'argv', camera_name, ' '.join(args.unknown))
                from watsor_tpu_torch.io.video import FallbackVideoDecoder
                return FallbackVideoDecoder(
                    camera_name, frame_queue, buffer_in, url,
                    argv=camera_config['ffmpeg']['decoder'],
                    rate_limiter=rate_limiter)
            _LOGGER.warning(
                'Camera %s: ffmpeg decoder flags not translated by the '
                'native runtime (ignored): %s (set WATSOR_FFMPEG_FALLBACK'
                '=1 to run them through a real ffmpeg subprocess)',
                camera_name, ' '.join(args.unknown))
        return VideoDecoder(camera_name, frame_queue, buffer_in, url,
                            options=args.options,
                            realtime=args.realtime or None,
                            input_format=args.input_format,
                            hwaccel=args.hwaccel,
                            hwaccel_device=args.hwaccel_device,
                            filter_fps=args.filter_fps,
                            rate_limiter=rate_limiter)

    def _create_encoder(self, camera_name, camera_config, buffer_out,
                        visual_effects):
        if 'encoder' not in camera_config.get('ffmpeg', {}):
            return None
        from watsor_tpu_torch.io.video import (VideoEncoder,
                                               encoder_args_from_argv)
        args = encoder_args_from_argv(camera_config['ffmpeg']['encoder'])
        if args.unknown:
            _LOGGER.warning(
                'Camera %s: ffmpeg encoder flags not translated by the '
                'native runtime (ignored): %s', camera_name,
                ' '.join(args.unknown))
        output_path = camera_config.get('output')
        encoder_queue = Queue(1)
        encoder = VideoEncoder(
            camera_name + '-encoder', encoder_queue, buffer_out,
            camera_config['width'], camera_config['height'],
            fps=args.fps or 30.0,
            output_path=output_path, broadcast=output_path is None,
            codec=args.codec, bit_rate=args.bit_rate, options=args.options,
            input_fps=args.input_fps, cfr=args.cfr,
            fmt=args.format if output_path else None,
            drawtext=args.drawtext)
        visual_effects.subscribe(encoder_queue)
        return encoder

    def _class_names(self, camera_config):
        return [next(iter(entry)) for entry in camera_config['detect']]

    def _setup_camera(self, camera_name, camera_config, frame_queue,
                      mqtt_config):
        from watsor_tpu_torch.filters import DetectionSieve
        from watsor_tpu_torch.output.snapshot import Snapshot
        from watsor_tpu_torch.output.visual import VisualEffects

        w, h = camera_config['width'], camera_config['height']
        detect_hw = (self.DETECT_SIZE, self.DETECT_SIZE)
        buffer_in = FrameBuffer(10, w, h, detect_hw=detect_hw)
        buffer_out = FrameBuffer(10, w, h)

        rate_limiter = RateLimiter()
        decoder = self._create_decoder(camera_name, camera_config,
                                       frame_queue, buffer_in, rate_limiter)

        track, zone_mask = self._create_filters(camera_name, camera_config,
                                                rate_limiter)
        if self._device_filters:
            from watsor_tpu_torch.ops.filter_device import threshold_tables, \
                zone_tables, ZoneRefiner
            conf, area = threshold_tables(camera_config['detect'])
            zs, za = zone_tables(zone_mask, camera_config['detect'])
            self._camera_tables[camera_name] = (conf, area, zs, za)
            # exact full-res zone pass over the device survivors (the
            # device grid over-approximates; this restores bit parity
            # with the host cascade); maskless cameras get NO entry so an
            # all-maskless deployment skips the refine branch entirely
            if zone_mask is not None:
                self._zone_refiners[camera_name] = ZoneRefiner(
                    zone_mask, camera_config['detect'])
        sieve_queue = Queue(1)
        sieve = DetectionSieve(camera_name + '-sieve', sieve_queue, buffer_in,
                               track, rate_limiter)
        decoder.subscribe(sieve_queue)

        effects_queue = Queue(1)
        visual_effects = VisualEffects(
            camera_name + '-effects', effects_queue, buffer_in, buffer_out,
            self._create_effects(zone_mask))
        sieve.subscribe(effects_queue)

        encoder = self._create_encoder(camera_name, camera_config,
                                       buffer_out, visual_effects)

        snapshot_queue = Queue(1)
        snapshot = Snapshot(camera_name + '-snapshot', snapshot_queue,
                            buffer_in, self._class_names(camera_config),
                            self._create_effects(zone_mask))
        sieve.subscribe(snapshot_queue)

        mqtt = None
        if mqtt_config:
            from watsor_tpu_torch.output.mqtt import MQTT
            mqtt_queue = Queue(1)
            mqtt = MQTT(camera_name + '-mqtt', camera_name, mqtt_queue,
                        buffer_in, mqtt_config,
                        self._class_names(camera_config), decoder)
            sieve.subscribe(mqtt_queue)

        return Camera(camera_name, camera_config, buffer_in, buffer_out,
                      decoder, sieve, visual_effects, encoder, snapshot,
                      mqtt, rate_limiter)

    def _detector_factory(self, config, precision=None):
        """device -> Detector, for the configured model and knobs;
        ``precision`` ('32' or '16') in place of TRT_FLOAT_PRECISION."""
        from watsor_tpu_torch.models.zoo import model_config
        model_name, watched, nms_mode = detector_spec_from_config(
            config, self._args)
        dtype = None
        precision = precision or os.environ.get('TRT_FLOAT_PRECISION')
        if precision:
            dtype = {'32': torch.float32, '16': torch.bfloat16}.get(precision)
            if dtype is None:
                raise SystemExit('TRT_FLOAT_PRECISION must be 32 or 16, got '
                                 '{!r}'.format(precision))
            if dtype == torch.float32:
                use_full_f32()
        quantize_mode = os.environ.get('WATSOR_QUANTIZE') or None
        if quantize_mode not in (None, '0', 'int8', 'int8_full'):
            raise SystemExit('WATSOR_QUANTIZE must be int8 or int8_full, got '
                             '{!r}'.format(quantize_mode))
        model_cfg = model_config(model_name)
        # int8 weights apply to the ssd_ models, as in the JAX package
        # (watsor_tpu/main.py:469): an EfficientDet or SSDLite stays float
        if quantize_mode == 'int8' and not model_name.startswith('ssd_'):
            _LOGGER.warning('WATSOR_QUANTIZE=int8 applies to the ssd_ models '
                            'only; %s keeps float weights', model_name)
            quantize_mode = None
        # the int8 walk runs its own convolutions (WATSOR_FUSED_BLOCKS is
        # ignored under int8_full, as in the JAX package)
        fused = os.environ.get('WATSOR_FUSED_BLOCKS') == '1' and \
            quantize_mode != 'int8_full'
        if fused and not _plain_v2(model_cfg):
            raise SystemExit('WATSOR_FUSED_BLOCKS=1 supports the plain '
                             'ssd_mobilenet_v2 model only (got {})'.format(
                                 model_name))
        if fused and quantize_mode == 'int8':
            raise SystemExit('WATSOR_QUANTIZE=int8 with WATSOR_FUSED_BLOCKS=1 '
                             'is not supported: the fused pack folds float '
                             'kernels, not int8 ones')
        calib = None
        if quantize_mode == 'int8_full':
            if not _plain_v2(model_cfg):
                raise SystemExit(
                    'WATSOR_QUANTIZE=int8_full supports the plain '
                    'ssd_mobilenet_v2 model only (got {})'.format(model_name))
            calib = self._calibration_images(model_cfg.input_size)
        self.DETECT_SIZE = model_cfg.input_size
        _LOGGER.info('Detection model: %s (input %dx%d, %s classes%s)',
                     model_name, self.DETECT_SIZE, self.DETECT_SIZE,
                     len(watched) if watched else 'all',
                     ', fused blocks' if fused else '')

        def make_detector(device):
            from watsor_tpu_torch.models.zoo import build_from_zoo
            detector = build_from_zoo(model_name, self._args.model_path,
                                      active_labels=watched,
                                      nms_mode=nms_mode, dtype=dtype,
                                      device=device)
            if quantize_mode == 'int8':
                # int8 kernels on the device, dequantized in each step
                from watsor_tpu_torch.models.quantize import \
                    build_quantized_detector
                detector = build_quantized_detector(
                    detector.config, detector.variables,
                    anchors=detector.anchors, device=device)
                _LOGGER.info('Weights quantized to int8')
            elif quantize_mode == 'int8_full':
                from watsor_tpu_torch.models.ssd_int8 import \
                    build_int8_detector
                detector = build_int8_detector(detector, calib)
                _LOGGER.info('Full int8-activation inference enabled')
            elif fused:
                from watsor_tpu_torch.models.ssd_fused import \
                    build_fused_detector
                detector = build_fused_detector(detector)
            return detector

        return make_detector

    def _calibration_images(self, size):
        """The int8_full calibration frames: WATSOR_CALIB_FILE (an npz with
        'images' [N, H, W, 3] uint8), else seeded noise of ``size`` with a
        warning."""
        import numpy as np
        calib_file = os.environ.get('WATSOR_CALIB_FILE')
        if calib_file:
            if not os.path.exists(calib_file):
                raise SystemExit(
                    'WATSOR_CALIB_FILE={} does not exist — refusing '
                    'to silently calibrate on noise'.format(calib_file))
            with np.load(calib_file) as data:
                return data['images']
        _LOGGER.warning(
            'WATSOR_QUANTIZE=int8_full without a calibration '
            'set (WATSOR_CALIB_FILE): calibrating activation '
            'scales on random noise — provide real frames for '
            'production accuracy')
        return np.random.RandomState(0).randint(0, 255, (8, size, size, 3),
                                                np.uint8)

    def _setup(self, config):
        from watsor_tpu_torch.detection import (TorchDetectorBackend,
                                                create_object_detectors)
        self._http_config = config.get('http', {})
        mqtt_config = config.get('mqtt')
        camera_names = [next(iter(c)) for c in config['cameras']]
        queues = balanced_queue_group(camera_names, maxsize=len(camera_names))

        # settle the model (and so the detect-plane size) before the
        # cameras' arenas are allocated
        backend_factory = self._backend_factory
        if backend_factory is None:
            make_detector = self._detector_factory(config)
            if self._fleet:
                from watsor_tpu_torch.parallel import make_mesh
                self._mesh = make_mesh()

        for camera in config['cameras']:
            camera_name = next(iter(camera))
            self._cameras.append(self._setup_camera(
                camera_name, camera[camera_name], queues[camera_name],
                mqtt_config))

        buffers = {c.name: c.buffer_in for c in self._cameras}
        if backend_factory is None:
            tables = self._camera_tables if self._device_filters else None
            refiners = self._zone_refiners if self._device_filters else None
            if self._mesh is not None:
                # one step whose batch spans every device of the mesh, in
                # place of one detector task per device
                from watsor_tpu_torch.detection import FleetBackend
                from watsor_tpu_torch.detection.detector import \
                    ObjectDetector
                from watsor_tpu_torch.parallel import FleetDetector
                fleet = FleetDetector(self._mesh,
                                      make_detector(self._mesh.devices[0]))
                self._detectors = [ObjectDetector(
                    'detector-fleet', next(iter(queues.values())), buffers,
                    FleetBackend(fleet, camera_tables=tables,
                                 zone_refiners=refiners),
                    max_batch=64)]
                return

            def backend_factory(device):
                return TorchDetectorBackend(make_detector(device), device,
                                            camera_tables=tables,
                                            zone_refiners=refiners)

        self._detectors = create_object_detectors(queues, buffers,
                                                  backend_factory)

    # -- HTTP --------------------------------------------------------------

    def _check_auth(self, environ):
        username = self._http_config.get('username')
        if not username:
            return True
        header = environ.get('HTTP_AUTHORIZATION', '')
        if not header.startswith('Basic '):
            return False
        try:
            decoded = base64.b64decode(header[6:]).decode()
        except Exception:
            return False
        expected = '{}:{}'.format(username,
                                  self._http_config.get('password', ''))
        # constant-time compare — a plain == leaks the match prefix length
        # through response timing
        return hmac.compare_digest(decoded.encode(), expected.encode())

    def _camera_by_name(self, name):
        for camera in self._cameras:
            if camera.name == name:
                return camera
        return None

    def _metrics(self):
        # JSON shape matches the reference consumer-for-consumer
        # (upstream watsor/main.py:221-253): cameras is a LIST of
        # {name, fps: {stage: value}, buffer_in, buffer_out} with
        # encoder/mqtt fps present only when configured; detectors carry
        # {name, fps, fps_max, inference_time}. The latency percentiles
        # are watsor-tpu additions (extra keys are additive-compatible).
        cameras = []
        for c in self._cameras:
            fps = {
                'decoder': round(c.decoder.fps.fps, 1),
                'sieve': round(c.sieve.fps.fps, 1),
                'visual_effects': round(c.visual_effects.fps.fps, 1),
                'snapshot': round(c.snapshot.fps.fps, 1),
            }
            if c.encoder is not None:
                fps['encoder'] = round(c.encoder.fps.fps, 1)
            if c.mqtt is not None:
                fps['mqtt'] = round(c.mqtt.fps.fps, 1)
            latency = {'sieve': {'p50': round(c.sieve.latency.p50, 1),
                                 'p95': round(c.sieve.latency.p95, 1)}}
            if c.encoder is not None:
                latency['encoder'] = {
                    'p50': round(c.encoder.latency.p50, 1),
                    'p95': round(c.encoder.latency.p95, 1)}
            if c.mqtt is not None:
                latency['mqtt'] = {'p50': round(c.mqtt.latency.p50, 1),
                                   'p95': round(c.mqtt.latency.p95, 1)}
            cameras.append({
                'name': c.name,
                'fps': fps,
                'buffer_in': round(c.buffer_in.fullness * 100),
                'buffer_out': round(c.buffer_out.fullness * 100),
                'latency_ms_p50': round(c.sieve.latency.p50, 1),
                'latency_ms': latency,
            })
        detectors = []
        for d in self._detectors:
            inference_time = d.inference_time.value
            detectors.append({
                'name': d.device_name,
                'fps': round(d.fps.fps, 1),
                'fps_max': round(1000.0 / inference_time)
                if inference_time else 0.0,
                'inference_time': round(inference_time, 1),
                # north-star metric: frame capture -> detections in header
                'latency_ms_p50': round(d.latency.p50, 1),
                'latency_ms_p95': round(d.latency.p95, 1),
            })
        return {'cameras': cameras, 'detectors': detectors}

    def _home_page(self):
        rows = []
        for c in self._cameras:
            links = ['<a href="/video/mjpeg/{0}">mjpeg</a>'.format(c.name)]
            if c.encoder is not None and c.encoder.ts_ring is not None:
                links.append(
                    '<a href="/video/mpegts/{0}">mpegts</a>'.format(c.name))
            for label in self._class_names(c.config):
                links.append('<a href="/snapshot/{0}/{1}">{1}</a>'.format(
                    c.name, label))
            rows.append('<li><b>{}</b> {}</li>'.format(c.name,
                                                       ' '.join(links)))
        return ('<html><head><title>watsor-tpu</title></head><body>'
                '<h1>watsor-tpu</h1><ul>{}</ul>'
                '<p><a href="/metrics">metrics</a> '
                '<a href="/health">health</a></p>'
                '</body></html>').format(''.join(rows))

    def _wsgi_app(self, environ, start_response):
        from werkzeug.wrappers import Request, Response

        request = Request(environ)
        path = request.path

        # every route is authenticated, /health included — the reference
        # authenticates its whole surface (upstream watsor/main.py:
        # 155-165); k8s-style probes can send credentials or auth can be
        # left off entirely
        if not self._check_auth(environ):
            response = Response(
                'Unauthorized', status=401,
                headers={'WWW-Authenticate':
                         'Basic realm="Access to Watsor"'})
            return response(environ, start_response)

        try:
            if path == '/':
                response = Response(self._home_page(), mimetype='text/html')
            elif path == '/health':
                response = Response('UP', mimetype='text/plain')
            elif path == '/metrics':
                # reference JSON shape by default; ?format=prometheus
                # serves the same data in the Prometheus text exposition
                # format (a watsor-tpu extension for scrape-based ops)
                if request.args.get('format') == 'prometheus':
                    response = Response(
                        _prometheus_metrics(self._metrics()),
                        mimetype='text/plain; version=0.0.4')
                else:
                    response = Response(
                        json.dumps(self._metrics(), indent=4),
                        mimetype='application/json')
            elif path == '/profiler':
                response = self._profiler_response(request)
            elif path.startswith('/snapshot/'):
                response = self._snapshot_response(path)
            elif path.startswith('/video/mjpeg/'):
                response = self._mjpeg_response(path, request)
            elif path.startswith('/video/mpegts/'):
                response = self._mpegts_response(path)
            else:
                response = Response('Not found', status=404)
        except Exception:
            _LOGGER.exception('HTTP handler error for %s', path)
            response = Response('Internal error', status=500)
        return response(environ, start_response)

    # keep at most this many capture directories; older ones are pruned so
    # repeated captures cannot grow the log volume without bound
    _PROFILER_KEEP = 8

    def _profiler_response(self, request):
        """GET /profiler?seconds=N: capture a torch.profiler trace (CUDA
        kernels and copies on the card with every thread's host operators
        and the program's spans, runtime/spans.py; the host's alone on the
        CPU) of whatever the service runs for N seconds (at most 10),
        written as a Chrome trace under ``watsor-trace-<t>`` in the log
        path (or the temp dir), viewable in Perfetto (counterpart of
        watsor_tpu/main.py:732-770). The answer names the directory and
        sums the capture's spans by name (``spans.summary``).

        Single-flight: one profiler runs at a time in a process, and each
        capture holds a request thread for up to 10 s, so a second
        concurrent request is answered 409."""
        import glob
        import shutil
        import tempfile
        import time as time_module

        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        from werkzeug.wrappers import Response

        from watsor_tpu_torch.runtime import spans

        if not self._profiler_lock.acquire(blocking=False):
            return Response(
                json.dumps({'error': 'profiler capture already in progress'}),
                status=409, mimetype='application/json')
        try:
            seconds = min(float(request.args.get('seconds', 2)), 10.0)
            base = self._args.log_path or tempfile.gettempdir()
            trace_dir = os.path.join(
                base, 'watsor-trace-{}'.format(int(time_module.time())))
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            # the detector and camera threads, not only this request's
            threads = _ExperimentalConfig(profile_all_threads=True)
            spans.clear()
            with profile(activities=activities,
                         experimental_config=threads) as prof:
                time_module.sleep(seconds)
            captured = spans.summary(spans.records())
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, 'trace.json'))
            stale = sorted(glob.glob(os.path.join(base, 'watsor-trace-*')))
            for old in stale[:-self._PROFILER_KEEP]:
                shutil.rmtree(old, ignore_errors=True)
            return Response(json.dumps({'trace_dir': trace_dir,
                                        'seconds': seconds,
                                        'spans': captured}),
                            mimetype='application/json')
        finally:
            self._profiler_lock.release()

    def _snapshot_response(self, path):
        from werkzeug.wrappers import Response
        parts = path.strip('/').split('/')
        if len(parts) != 3:
            return Response('Not found', status=404)
        camera = self._camera_by_name(parts[1])
        if camera is None:
            return Response('Unknown camera', status=404)
        data = camera.snapshot.get(parts[2])
        if data is None:
            return Response('No snapshot yet', status=404)
        return Response(data, mimetype='image/jpeg')

    def _mjpeg_response(self, path, request=None):
        from werkzeug.wrappers import Response
        from watsor_tpu_torch.output.http_stream import (JpegCacheSet,
                                                         MotionJpeg)
        camera = self._camera_by_name(path.rsplit('/', 1)[-1])
        if camera is None:
            return Response('Unknown camera', status=404)
        # viewer knobs (all optional; extensions over the reference's
        # fixed source-rate source-resolution stream, output/video.py:118):
        #   ?scale=N      serve at 1/N resolution (downscale fused into the
        #                 persistent native encoder's swscale pass)
        #   ?res=detect   serve the rendered output downscaled to the
        #                 model's detection resolution (NOT the raw
        #                 detect plane — overlays/effects are included)
        #   ?fps=F        cap this viewer's delivery rate
        #   ?quality=Q    JPEG quality 1-100 (default 80)
        args = request.args if request is not None else {}
        out_hw, max_fps, quality = None, None, 80
        try:
            src_h, src_w = camera.buffer_out.arena.shape[1:3]
            if args.get('res') == 'detect':
                if camera.buffer_in.detect_arena is None:
                    return Response('Camera has no detection plane',
                                    status=400)
                out_hw = camera.buffer_in.detect_arena.shape[1:3]
            elif 'scale' in args:
                n = max(1, min(16, int(args['scale'])))
                out_hw = (src_h // n, src_w // n)
            if 'fps' in args:
                max_fps = max(0.1, min(240.0, float(args['fps'])))
            if 'quality' in args:
                quality = max(1, min(100, int(args['quality'])))
        except (TypeError, ValueError):
            return Response('Bad query parameter', status=400)
        # ONE JPEG cache per camera per (resolution, quality) variant,
        # shared by all viewers of that variant: each frame is encoded at
        # most once per variant regardless of viewer count (the reference's
        # shared epoch-keyed cache, output/video.py:120-132)
        cache = self._jpeg_caches.setdefault(
            camera.name, JpegCacheSet()).get_cache(out_hw, quality)
        stream = MotionJpeg(camera.name + '-mjpeg', camera.visual_effects,
                            camera.buffer_out, jpeg_cache=cache,
                            stop_event=self._stop_main, max_fps=max_fps)
        response = Response(iter(stream), mimetype=stream.mime_type)
        response.call_on_close(stream.close)
        return response

    def _mpegts_response(self, path):
        from werkzeug.wrappers import Response
        from watsor_tpu_torch.output.http_stream import MpegTS
        camera = self._camera_by_name(path.rsplit('/', 1)[-1])
        if camera is None:
            return Response('Unknown camera', status=404)
        if camera.encoder is None or camera.encoder.ts_ring is None:
            return Response('No MPEG-TS broadcast configured', status=404)
        stream = MpegTS(camera.name + '-mpegts', camera.encoder,
                        stop_event=self._stop_main)
        response = Response(iter(stream), mimetype=stream.mime_type)
        response.call_on_close(stream.close)
        return response

    def _http_serve(self):
        port = self._http_config.get('port', 8080)
        self._http_server = make_http_server(port, self._wsgi_app)
        thread = threading.Thread(name='http', daemon=True,
                                  target=self._http_server.serve_forever)
        thread.start()
        _LOGGER.info('HTTP server listening on port %d', port)

    # -- lifecycle ---------------------------------------------------------

    def _all_tasks(self):
        for c in self._cameras:
            yield from filter(None, (c.sieve, c.visual_effects, c.snapshot,
                                     c.encoder, c.mqtt, c.decoder))
        yield from self._detectors

    def _install_signal_handler(self):
        def handler(signum, frame):
            _LOGGER.info('Signal %d received, shutting down', signum)
            self._stop_main.set()
        try:
            signal.signal(signal.SIGINT, handler)
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread (embedded/test usage)

    def run(self):
        """Start HTTP, build the graph and serve until stopped. Unlike the
        JAX package's ``run`` there is no platform pin and no discovery
        probe: the device pool decides where detection runs."""
        init_logging(self._args.log_level, self._args.log_path)
        self._install_signal_handler()
        config = self._read_config()
        # HTTP first: /health and /metrics answer during the model build
        self._http_config = config.get('http', {})
        self._http_serve()
        self._setup(config)

        decoders = [c.decoder for c in self._cameras]
        for task in self._all_tasks():
            if task in decoders:
                continue
            task.start()
            self._watchdog.add(task)

        def start_decoders_when_warm():
            # camera ingest waits for every detector's warmup
            for detector in self._detectors:
                while not detector.ready.wait(1.0):
                    if self._stop_main.is_set():
                        return
            if self._stop_main.is_set():
                return
            for task in decoders:
                task.start()
                self._watchdog.add(task)

        threading.Thread(target=start_decoders_when_warm,
                         name='decoder-gate', daemon=True).start()
        self._watchdog.start()

        _LOGGER.info('watsor-tpu-torch running: %d camera(s), %d '
                     'detector(s)', len(self._cameras),
                     len(self._detectors))
        try:
            self._stop_main.wait()
        finally:
            self._shutdown()

    def _shutdown(self):
        _LOGGER.info('Stopping...')
        self._stop_main.set()           # ends the video streams being served
        self._watchdog.join(5)
        if self._http_server is not None:
            self._http_server.shutdown()
        for task in self._all_tasks():
            task.terminate()
        for task in self._all_tasks():
            task.join(30)
        if self._http_server is not None:
            left = self._http_server.close_requests()
            if left:
                _LOGGER.warning('HTTP request threads still running: %s',
                                ', '.join(left))
        if self._device_renderer is not None:
            self._device_renderer.close()
        _LOGGER.info('Stopped')


def make_http_server(port, app, host='0.0.0.0'):
    """werkzeug's threaded WSGI server for ``app``, which also keeps each
    open connection with the thread serving it, so that the application's
    shutdown ends every request (``close_requests``) instead of leaving
    their threads behind."""
    from werkzeug.serving import ThreadedWSGIServer

    class Server(ThreadedWSGIServer):
        # the connections are tracked here, and server_close must not
        # wait for their threads without a limit
        block_on_close = False

        def __init__(self, *args, **kwargs):
            self._open = {}             # connection -> its thread, once known
            self._open_changed = threading.Condition()
            super().__init__(*args, **kwargs)

        def process_request(self, request, client_address):
            with self._open_changed:
                self._open[request] = None
            super().process_request(request, client_address)

        def process_request_thread(self, request, client_address):
            with self._open_changed:
                self._open[request] = threading.current_thread()
            try:
                super().process_request_thread(request, client_address)
            finally:
                with self._open_changed:
                    self._open.pop(request, None)
                    self._open_changed.notify_all()

        def _wait_closed(self, timeout):
            with self._open_changed:
                self._open_changed.wait_for(lambda: not self._open, timeout)
                return dict(self._open)

        def close_requests(self, grace_s=5.0):
            """After ``shutdown()``: give the open requests ``grace_s`` to
            end, then cut their connections (a viewer that stopped reading
            blocks its thread in a write) and wait as long again; close the
            listening socket. Returns the names of the request threads still
            running."""
            left = self._wait_closed(grace_s)
            for request in left:
                try:
                    request.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass                # already closed
            left = self._wait_closed(grace_s)
            self.server_close()
            return sorted(t.name if t is not None else 'starting'
                          for t in left.values())

    return Server(host, port, app)


def main(argv=None):
    args = _parse_commandline_arguments(argv)
    if args.check_config:
        raise SystemExit(1 if check_config(args) else 0)
    TorchApplication(args).run()


if __name__ == '__main__':
    main()
