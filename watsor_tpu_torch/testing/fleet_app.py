"""Boot the port's whole application (synthetic static cameras -> zones +
device filters -> detector -> sieve/tracker -> MQTT detail payloads)
against the in-process broker and collect one steady-state detail payload
per (camera, class) (counterpart of watsor_tpu/testing/fleet_app.py:38-159,
booting ``TorchApplication`` in place of ``Application``).

Used by tests/test_torch_app.py (fleet against single device at the
operator surface): ``synthetic://static`` gives every frame of a camera the
same pixels, so two runs converge to the same detections whatever the
timing, drops or batch composition.
"""

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import torch

CAMERA = """
  - cam{i:02d}:
      width: {w}
      height: {h}
      input: synthetic://static?seed={i}
      mask: {mask}
      detect:
        - person: {{confidence: 10, area: 1, zones: [1]}}
        - bicycle: {{confidence: 10, area: 1}}
        - car: {{confidence: 10, area: 1}}
      ffmpeg:
        decoder: [-i, -f, rawvideo, -pix_fmt, rgb24]
"""


def tiny_ssd_config():
    """A real (small) SSD config, as watsor_tpu/testing/fleet_app.py's:
    the fleet shards a genuine detect step at a bounded cost."""
    from watsor_tpu_torch.models.ssd import SSDConfig
    return SSDConfig(num_classes=3, input_size=96, width_multiplier=0.35,
                     extra_features=(32, 32, 32, 32), dtype=torch.float32)


def write_mask(path, frame_hw):
    import cv2
    h, w = frame_hw
    image = np.zeros((h, w, 4), np.uint8)
    image[:, :, :3] = 200
    image[4:h - 4, 4:w - 28, 3] = 255    # zone 1: most of the frame
    cv2.imwrite(path, image)


def details_key(payload):
    """Detection content of a details payload, timestamp stripped."""
    body = json.loads(payload)
    return tuple(sorted(
        (d['c'], tuple(d['b']), tuple(d.get('z', []))) for d in body['d']))


def _free_port():
    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def run_app(tmp_path, fleet, n_cams=32, frame_hw=(64, 96),
            device_pool=None, model_name='ssd_tiny_test', steady_timeout=300,
            details_timeout=240, min_camera_frac=0.75):
    """Boot TorchApplication with ``n_cams`` cameras of ``frame_hw``
    (height, width), WATSOR_FLEET on or off and ``device_pool`` as
    WATSOR_DEVICE_POOL (None: the environment's), enable MQTT details on
    every camera, collect one steady-state detail payload per (camera,
    class), and return ({camera: {class: detections}}, detector name).
    Raises RuntimeError when the app never reaches steady state or too few
    cameras report."""
    from watsor_tpu_torch.main import (TorchApplication,
                                       _parse_commandline_arguments)
    from watsor_tpu_torch.testing.broker import MiniBroker

    port = _free_port()
    broker = MiniBroker()
    h, w = frame_hw
    mask = os.path.join(str(tmp_path), 'mask_{}.png'.format(fleet))
    write_mask(mask, frame_hw)
    config = ('http:\n  port: {}\nmqtt:\n  host: 127.0.0.1\n  port: {}\n'
              'model: {}\ncameras:'.format(port, broker.port, model_name)
              + ''.join(CAMERA.format(i=i, w=w, h=h, mask=mask)
                        for i in range(n_cams)))
    config_file = os.path.join(str(tmp_path),
                               'config_{}.yaml'.format(fleet))
    with open(config_file, 'w') as f:
        f.write(config)

    env = {'WATSOR_FLEET': '1' if fleet else '0',
           'WATSOR_DEVICE_RENDER': '1',
           'TRT_FLOAT_PRECISION': '32'}
    if device_pool is not None:
        env['WATSOR_DEVICE_POOL'] = device_pool
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    app = TorchApplication(_parse_commandline_arguments(
        ['-c', config_file, '-m', os.path.join(str(tmp_path), 'none')]))
    thread = threading.Thread(target=app.run, daemon=True)
    try:
        thread.start()
        url = 'http://127.0.0.1:{}'.format(port)

        # cameras up and detector consuming
        deadline = time.time() + steady_timeout
        metrics = None
        while time.time() < deadline:
            try:
                metrics = json.loads(urllib.request.urlopen(
                    url + '/metrics', timeout=2).read())
                if len(metrics['cameras']) == n_cams and \
                        metrics['detectors'][0]['fps'] > 0:
                    break
            except (OSError, ValueError, KeyError, IndexError):
                pass
            time.sleep(0.5)
        else:
            raise RuntimeError('application never reached steady state '
                               '(fleet={})'.format(fleet))
        detector_name = metrics['detectors'][0]['name']

        # turn on detail publishing everywhere (operator command)
        for i in range(n_cams):
            topic = 'watsor/cameras/cam{:02d}/command'.format(i)
            if not broker.wait_subscribed(topic, timeout=60):
                raise RuntimeError('camera {} never subscribed its '
                                   'command topic'.format(i))
            broker.publish(topic, 'details = on')

        # steady-state detail payloads per (camera, class): keep the LAST
        # payload seen (the tracker's first reports can still be
        # history-merging while its window fills)
        details = {}
        deadline = time.time() + details_timeout
        while time.time() < deadline:
            with broker.received:
                records = list(broker.records)
            for topic, payload, _ in records:
                if topic.endswith('/details'):
                    parts = topic.split('/')
                    details[(parts[2], parts[4])] = details_key(payload)
            if len({cam for cam, _ in details}) >= n_cams:
                break
            time.sleep(0.5)
        cameras = {cam for cam, _ in details}
        if len(cameras) < n_cams * min_camera_frac:
            raise RuntimeError(
                'details flowed for only {} of {} cameras (fleet={})'
                .format(len(cameras), n_cams, fleet))
        by_camera = {}
        for (cam, cls), value in details.items():
            by_camera.setdefault(cam, {})[cls] = value
        return by_camera, detector_name
    finally:
        app._stop_main.set()
        thread.join(60)
        broker.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
