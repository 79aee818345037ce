"""The port's composition root: the JAX package's ``Application`` with its
device seams replaced.

    python -m watsor_tpu_torch.main -c config/config.yaml [--model NAME]

``TorchApplication`` reuses the whole host graph (decoders, balanced
queue, sieve, effects, snapshot, MQTT, HTTP) and overrides only what
touches JAX: the detector build, the device-filter tables, the device
pool, the platform pin and discovery probe in ``run``, and the profiler
route. Knobs honoured as in the JAX package: ``TRT_FLOAT_PRECISION=32|16``,
``WATSOR_FUSED_BLOCKS=1``, ``WATSOR_QUANTIZE=int8|int8_full`` (with
``WATSOR_CALIB_FILE`` and ``WATSOR_INT8_POINTWISE=conv|dot|pallas``),
``WATSOR_DEVICE_FILTERS=0``, ``WATSOR_DEVICE_POOL``. Knobs whose paths are
not ported yet raise.
"""

import json
import logging
import os
import threading

import torch

from watsor_tpu.main import Application, _parse_commandline_arguments
from watsor_tpu_torch.host import (balanced_queue_group, coco_label_index,
                                   init_logging)

_LOGGER = logging.getLogger('watsor_tpu_torch.main')

_NOT_PORTED = 'is not ported to watsor_tpu_torch yet (ROADMAP.md, queue A)'


def detector_spec_from_config(config, args):
    """(model_name, watched labels or None, nms mode) for this config."""
    from watsor_tpu_torch.models.zoo import DEFAULT_MODEL, MODEL_REGISTRY
    model_name = getattr(args, 'model', None) or config.get('model') \
        or DEFAULT_MODEL
    if model_name not in MODEL_REGISTRY:
        raise SystemExit("model '{}' {}; available: {}".format(
            model_name, _NOT_PORTED, ', '.join(sorted(MODEL_REGISTRY))))
    watched = set()
    for camera in config['cameras']:
        camera_config = camera[next(iter(camera))]
        for entry in camera_config['detect']:
            label = coco_label_index(next(iter(entry)))
            if label:
                watched.add(label)
    return model_name, watched or None, config.get('nms')


class TorchApplication(Application):
    """``Application`` on the PyTorch detection path."""

    @property
    def _device_filters(self):
        # The base class builds JAX device-filter tables where this is
        # true; this class builds its own in _create_filters instead.
        return False

    @property
    def _torch_device_filters(self):
        return os.environ.get('WATSOR_DEVICE_FILTERS', '1') != '0' and \
            self._backend_factory is None

    def _create_filters(self, camera_name, camera_config, rate_limiter):
        track, zone_mask = super()._create_filters(camera_name,
                                                   camera_config,
                                                   rate_limiter)
        if not self._torch_device_filters:
            return track, zone_mask
        from watsor_tpu_torch.host import TrackFilter
        from watsor_tpu_torch.ops.filter_device import (ZoneRefiner,
                                                        threshold_tables,
                                                        zone_tables)
        detect = camera_config['detect']
        conf, area = threshold_tables(detect)
        zs, za = zone_tables(zone_mask, detect)
        self._camera_tables[camera_name] = (conf, area, zs, za)
        # the exact full-resolution zone pass over the device survivors;
        # maskless cameras get no entry
        if zone_mask is not None:
            self._zone_refiners[camera_name] = ZoneRefiner(zone_mask, detect)
        # the cascade runs on the device; the sieve keeps only the tracker
        return TrackFilter([]), zone_mask

    def _create_effects(self, zone_mask):
        # the base class defaults device render on under WATSOR_FLEET=1
        render = os.environ.get('WATSOR_DEVICE_RENDER') or \
            ('1' if os.environ.get('WATSOR_FLEET') == '1' else '0')
        if render == '1' and zone_mask is None:
            raise SystemExit('device overlay render (WATSOR_DEVICE_RENDER, '
                             'WATSOR_FLEET) ' + _NOT_PORTED)
        return super()._create_effects(zone_mask)

    def _detector_factory(self, config):
        """device -> Detector, for the configured model and knobs."""
        from watsor_tpu_torch.models.zoo import MODEL_REGISTRY
        if os.environ.get('WATSOR_FLEET') not in (None, '', '0'):
            raise SystemExit('WATSOR_FLEET={} {}'.format(
                os.environ['WATSOR_FLEET'], _NOT_PORTED))
        model_name, watched, nms_mode = detector_spec_from_config(
            config, self._args)
        dtype = None
        precision = os.environ.get('TRT_FLOAT_PRECISION')
        if precision:
            dtype = {'32': torch.float32, '16': torch.bfloat16}.get(precision)
            if dtype is None:
                raise SystemExit('TRT_FLOAT_PRECISION must be 32 or 16, got '
                                 '{!r}'.format(precision))
        quantize_mode = os.environ.get('WATSOR_QUANTIZE') or None
        if quantize_mode not in (None, '0', 'int8', 'int8_full'):
            raise SystemExit('WATSOR_QUANTIZE must be int8 or int8_full, got '
                             '{!r}'.format(quantize_mode))
        # the int8 walk runs its own convolutions (WATSOR_FUSED_BLOCKS is
        # ignored under int8_full, as in the JAX package)
        fused = os.environ.get('WATSOR_FUSED_BLOCKS') == '1' and \
            quantize_mode != 'int8_full'
        if fused and quantize_mode == 'int8':
            raise SystemExit('WATSOR_QUANTIZE=int8 with WATSOR_FUSED_BLOCKS=1 '
                             'is not supported: the fused pack folds float '
                             'kernels, not int8 ones')
        calib = None
        if quantize_mode == 'int8_full':
            calib = self._calibration_images(model_name)
        self.DETECT_SIZE = MODEL_REGISTRY[model_name].input_size
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

    def _calibration_images(self, model_name):
        """The int8_full calibration frames: WATSOR_CALIB_FILE (an npz with
        'images' [N, H, W, 3] uint8), else seeded noise with a warning."""
        import numpy as np
        from watsor_tpu_torch.models.zoo import MODEL_REGISTRY
        if not model_name.startswith('ssd_mobilenet_v2'):
            raise SystemExit(
                'WATSOR_QUANTIZE=int8_full supports the plain '
                'ssd_mobilenet_v2 model only (got {})'.format(model_name))
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
        size = MODEL_REGISTRY[model_name].input_size
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

        for camera in config['cameras']:
            camera_name = next(iter(camera))
            self._cameras.append(self._setup_camera(
                camera_name, camera[camera_name], queues[camera_name],
                mqtt_config))

        if backend_factory is None:
            tables = self._camera_tables if self._torch_device_filters \
                else None
            refiners = self._zone_refiners if self._torch_device_filters \
                else None

            def backend_factory(device):
                return TorchDetectorBackend(make_detector(device), device,
                                            camera_tables=tables,
                                            zone_refiners=refiners)

        buffers = {c.name: c.buffer_in for c in self._cameras}
        self._detectors = create_object_detectors(queues, buffers,
                                                  backend_factory)

    def _profiler_response(self, request):
        from werkzeug.wrappers import Response
        return Response(json.dumps({'error': 'the profiler route ' +
                                    _NOT_PORTED}),
                        status=501, mimetype='application/json')

    def run(self):
        """``Application.run`` without the JAX platform pin and discovery
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


def main(argv=None):
    args = _parse_commandline_arguments(argv)
    if args.check_config:
        raise SystemExit('--check-config ' + _NOT_PORTED +
                         '; run python -m watsor_tpu.main --check-config')
    TorchApplication(args).run()


if __name__ == '__main__':
    main()
