"""The device pool and the detector tasks (counterpart of
watsor_tpu/detection/detector.py:236-326). The detector task itself is the
JAX package's ``ObjectDetector``, which is device-agnostic."""

import logging
import os

import torch

from watsor_tpu_torch.host import ObjectDetector


def _platform_devices(platform):
    if platform == 'cuda':
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    if platform == 'cpu':
        return [torch.device('cpu')]
    return []


def resolve_device_pool(pool_spec=None):
    """The devices detectors are created over.

    By default every CUDA device. ``WATSOR_DEVICE_POOL`` (or ``pool_spec``)
    takes a comma list of ``platform[:count]`` entries, ``cuda`` or
    ``cpu``, as the JAX package does. With no CUDA device and no ``cpu``
    entry this raises: the port never falls back to the CPU silently."""
    spec = pool_spec if pool_spec is not None \
        else os.environ.get('WATSOR_DEVICE_POOL', '')
    log = logging.getLogger(__name__)
    devices = []
    for entry in spec.split(','):
        entry = entry.strip()
        if not entry:
            continue
        platform, _, count = entry.partition(':')
        platform = platform.strip().lower()
        pool = _platform_devices(platform)
        if not pool:
            log.warning('WATSOR_DEVICE_POOL: no %r devices visible — '
                        'skipping the entry', platform)
            continue
        if count.strip():
            try:
                limit = int(count)
            except ValueError:
                log.warning('WATSOR_DEVICE_POOL: bad count %r in %r — '
                            'skipping the entry', count.strip(), entry)
                continue
            if limit <= 0:
                log.warning('WATSOR_DEVICE_POOL: non-positive count in %r '
                            '— skipping the entry', entry)
                continue
            pool = pool[:limit]
        devices.extend(d for d in pool if d not in devices)
    if not devices:
        devices = _platform_devices('cuda')
    if not devices:
        raise RuntimeError(
            'No CUDA device visible and WATSOR_DEVICE_POOL names no cpu '
            'entry (set WATSOR_DEVICE_POOL=cpu:1 to detect on the CPU)')
    return devices


def create_object_detectors(frame_queue_group, frame_buffers, backend_factory,
                            stop_event=None, max_batch=64, pool_spec=None):
    """One detector task per device of the pool, all draining the same
    balanced queue. ``backend_factory(device) -> DetectorBackend``."""
    devices = resolve_device_pool(pool_spec)
    any_queue = next(iter(frame_queue_group.values()))
    # a single camera should never wait for the gather window
    window_ms = 4.0 if len(frame_buffers) > 1 else 0.0
    return [ObjectDetector('detector{}'.format(i + 1), any_queue,
                           frame_buffers, backend_factory(device),
                           stop_event=stop_event, max_batch=max_batch,
                           batch_window_ms=window_ms)
            for i, device in enumerate(devices)]
