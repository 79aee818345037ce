"""The detector task and the device pool (counterpart of
watsor_tpu/detection/detector.py). ``ObjectDetector`` is copied from
watsor_tpu/detection/detector.py:33-233 with its imports changed and the
program's spans added (runtime/spans.py, recorded while a torch.profiler
capture runs): ``detector.gather`` (count ``frames``), ``detector.stage``
(``resized``) and ``detector.scatter`` (``frames``, ``dropped``), with
``detector.scatter.write``, ``detector.scatter.latch`` and
``detector.scatter.meters`` inside it once a frame. It is
device-agnostic, and the pool below hands it PyTorch devices."""

import logging
import os
import threading
from queue import Empty
from time import monotonic, time
from typing import Dict

import numpy as np
import torch

from watsor_tpu_torch.runtime import spans
from watsor_tpu_torch.runtime.frames import DETECTION_DTYPE, MAX_DETECTIONS
from watsor_tpu_torch.runtime.meters import FramesPerSecond, InferenceTime, \
    LatencyMeter
from watsor_tpu_torch.runtime.tasks import Task


class ObjectDetector(Task):
    """Pulls payloads from the shared balanced queue, assembles a uint8
    staging batch at the model input resolution, runs the fused device step,
    and scatters results into the frame headers."""

    def __init__(self, name, frame_queue, frame_buffers: Dict[str, object],
                 backend, stop_event=None, max_batch=32,
                 batch_window_ms=4.0):
        self.frame_buffers = frame_buffers
        self.frame_queue = frame_queue
        self._backend = backend
        self._max_batch = max_batch
        # after the first frame arrives, keep gathering for up to this long
        # so concurrent cameras land in ONE device step (bounded latency
        # cost, large MXU utilization win — SURVEY.md §7 hard-part 2)
        self._batch_window = batch_window_ms / 1000.0
        h, w = backend.input_hw
        # two staging buffers, ping-ponged per dispatch: batch N+1 stages
        # (and starts its H2D) while batch N computes — the async-pipeline
        # design the reference gets from CUDA streams
        # (upstream watsor/detection/tensorrt_gpu.py:145-160)
        self._staging = np.zeros((2, max_batch, h, w, 3), np.uint8)
        self._staging_sel = 0
        self._inflight = None  # (backend handle, frames of the batch)
        self.fps = FramesPerSecond()
        self.inference_time = InferenceTime()
        # north-star metric: frame capture -> detections-in-header
        self.latency = LatencyMeter()
        # set once warmup compiled the serving program: the application
        # gates camera ingest on it (the reference holds ffmpeg under
        # SIGSTOP until the workers are up, stream/ffmpeg.py:43-44 —
        # frames decoded into a cold detector only age past the stale
        # limit and are thrown away)
        self.ready = threading.Event()
        super().__init__(name, stop_event)

    @property
    def device_name(self):
        return self._backend.device_name

    def _on_start(self):
        # compile before the first real frame arrives (the reference builds
        # its TRT engine offline for the same reason, main_for_gpu.py:17-26).
        # Warm the bucket the live batches will actually hit: with N
        # cameras the first real batch pads to bucket(N), and compiling it
        # in-line would stall past the 30 s stale-frame reclaim.
        try:
            self._backend.warmup(batch=min(max(len(self.frame_buffers), 1),
                                           self._max_batch))
        except Exception:
            self._logger.exception('Detector warmup failed')
        finally:
            self.ready.set()

    def _process(self):
        with spans.span('detector.gather') as traced:
            payloads = self._gather()
            traced.count(frames=len(payloads))
        if not payloads:
            self._finish_inflight()
            return
        self._detect(payloads)

    def _gather(self):
        """The next batch's payloads: the first within the poll, then more
        until the batch is full or the window after the first has passed;
        none when the poll found nothing."""
        try:
            # with a step in flight, poll briefly so its results scatter
            # promptly even when no new frames arrive
            payload = self.frame_queue.get(
                timeout=0.002 if self._inflight is not None else 1)
        except Empty:
            return []
        payloads = [payload]
        deadline = monotonic() + self._batch_window
        while len(payloads) < self._max_batch:
            try:
                payloads.append(self.frame_queue.get_nowait())
            except Empty:
                remaining = deadline - monotonic()
                if remaining <= 0:
                    break
                try:
                    payloads.append(self.frame_queue.get(timeout=remaining))
                except Empty:
                    break
        return payloads

    def _stage(self, staging, index, frame):
        """Copy one frame into the staging batch, resizing on the host only
        when the decode resolution differs from the detect resolution (the
        decoder normally emits a detect-resolution plane, making this a
        straight memcpy). Returns whether it resized."""
        h, w = self._backend.input_hw
        detect_plane = getattr(frame, 'detect_plane', None)
        if detect_plane is not None and detect_plane.shape[:2] == (h, w):
            staging[index] = detect_plane
        elif frame.image.shape[:2] == (h, w):
            staging[index] = frame.image
        else:
            import cv2
            cv2.resize(frame.image, (w, h), dst=staging[index],
                       interpolation=cv2.INTER_LINEAR)
            return True
        return False

    def _detect(self, payloads):
        frames = []
        senders = []
        staging = self._staging[self._staging_sel]
        with spans.span('detector.stage') as traced:
            resized = 0
            for p in payloads:
                frame = self.frame_buffers[p.sender].frames[p.frame_index]
                resized += self._stage(staging, len(frames), frame)
                frames.append(frame)
                senders.append(p.sender)
            traced.count(resized=resized)

        # epoch snapshot: if a frame is force-reclaimed (30 s stale rule)
        # while this batch is in flight, its epoch changes — the late
        # confirmation must then be dropped, not advance the new owner's
        # latch
        epochs = [frame.epoch for frame in frames]

        dispatch = getattr(self._backend, 'dispatch', None)
        if dispatch is None:
            # synchronous protocol (test doubles): no pipelining
            try:
                result = self._backend.detect_batch(staging[:len(frames)],
                                                    senders=senders)
            except Exception:
                self._logger.exception('Detection step failed')
                for frame in frames:
                    frame.latch.next()
                return
            self._scatter(result, frames, epochs)
            return

        try:
            handle = dispatch(staging[:len(frames)], senders=senders)
        except Exception:
            self._logger.exception('Detection dispatch failed')
            for frame in frames:
                frame.latch.next()
            return
        # the previous step computed while this batch staged + transferred
        self._staging_sel ^= 1
        self._finish_inflight()
        self._inflight = (handle, frames, epochs)

    def _finish_inflight(self):
        if self._inflight is None:
            return
        handle, frames, epochs = self._inflight
        self._inflight = None
        try:
            result = self._backend.resolve(handle)
        except Exception:
            self._logger.exception('Detection step failed')
            for frame, epoch in zip(frames, epochs):
                if frame.epoch == epoch:
                    frame.latch.next()
            return
        self._scatter(result, frames, epochs)

    def _on_stop(self):
        # never strand a dispatched batch: its frames hold latch confirms
        self._finish_inflight()

    def _scatter(self, result, frames, epochs=None):
        boxes, scores, classes, valid, device_ms = result[:5]
        zones_hit = result[5] if len(result) > 5 else None

        per_frame_ms = device_ms / len(frames)
        now = time()
        with spans.span('detector.scatter', frames=len(frames)) as traced:
            dropped = 0
            for i, frame in enumerate(frames):
                if epochs is not None and frame.epoch != epochs[i]:
                    # the slot was force-reclaimed and re-owned while this
                    # batch was in flight; confirming would corrupt the new
                    # owner's latch cycle
                    self._logger.warning(
                        'Dropping late detections for a reclaimed frame '
                        'slot')
                    dropped += 1
                    continue
                # read before the latch confirms: the slot may be re-owned
                # once it has
                latency_ms = (now - frame.epoch) * 1000.0 \
                    if frame.epoch > 0 else None
                if zones_hit is None:
                    n = min(int(valid[i]), MAX_DETECTIONS)
                    rows = np.arange(n)
                else:
                    # device-filtered: kept rows are flagged, not compacted
                    rows = np.nonzero(scores[i] > 0.0)[0][:MAX_DETECTIONS]
                    n = len(rows)
                records = np.zeros(n, DETECTION_DTYPE)
                if n:
                    fh, fw = frame.image.shape[:2]
                    px = boxes[i, rows] * np.array([fh, fw, fh, fw],
                                                   np.float32)
                    records['label'] = classes[i, rows]
                    records['confidence'] = scores[i, rows]
                    records['bbox'] = px
                    if zones_hit is not None:
                        # vectorized zone scatter: stable-sort hit columns
                        # first (ascending zone index), mask the tail — no
                        # Python loop per detection (this runs 32x30 times
                        # a second)
                        hits = zones_hit[i, rows]              # [n, Z] bool
                        width = min(10, hits.shape[1])
                        order = np.argsort(~hits, axis=1,
                                           kind='stable')[:, :width]
                        mask = np.take_along_axis(hits, order, axis=1)
                        records['zones'][:, :width] = np.where(
                            mask, order + 1, 0)
                        records['num_zones'] = mask.sum(axis=1)
                with spans.span('detector.scatter.write'):
                    frame.set_detections(records)
                with spans.span('detector.scatter.latch'):
                    frame.latch.next()
                with spans.span('detector.scatter.meters'):
                    if latency_ms is not None:
                        self.latency(latency_ms)
                    self.fps(True)
                    self.inference_time(per_frame_ms)
            traced.count(dropped=dropped)


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
