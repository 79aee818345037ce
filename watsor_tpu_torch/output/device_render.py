"""Batched device rendering: box overlays for many cameras in one device
step (counterpart of watsor_tpu/output/device_render.py:16-152).

Each camera's visual-effects thread submits its frame to a shared
``DeviceRenderer``; a collector thread per frame resolution gathers
requests for a few milliseconds, pads them to a size bucket and draws
every box of every frame in one call of ops/overlay.render_boxes. Labels
are stamped on the host afterwards (``DeviceDrawEffect``).

On the card each batch goes up from a pinned staging buffer (two per
bucket shape, used in turn), renders on the renderer's own stream and
comes back in one copy. A batch that fails is logged with its traceback,
counted in ``failures`` and passed through unrendered; a request that
waits past its timeout gets its own frame back and is counted in
``timeouts``: a live stream without boxes beats a dead one.
"""

import contextlib
import logging
import threading
from queue import Empty, Queue
from time import monotonic

import numpy as np
import torch

from watsor_tpu_torch.config.coco import get_coco_class
from watsor_tpu_torch.detection.backend import PinnedStaging
from watsor_tpu_torch.models.ssd import resolve_device
from watsor_tpu_torch.ops.overlay import (coco_color_table, pixel_index,
                                          render_boxes)
from watsor_tpu_torch.runtime.frames import MAX_DETECTIONS

_LOGGER = logging.getLogger('watsor_tpu_torch.render')

_BUCKETS = (1, 2, 4, 8, 16)


def _bucket(n):
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


class _Request:
    __slots__ = ('image', 'boxes', 'classes', 'result', 'done')

    def __init__(self, image, boxes, classes):
        self.image = image
        self.boxes = boxes
        self.classes = classes
        self.result = None
        self.done = threading.Event()


class DeviceRenderer:
    """Micro-batching collector around ops/overlay.render_boxes on one
    device (None: the current CUDA device; pass 'cpu' for the CPU).

    Counters, read by the application and its checks: ``batches`` and
    ``frames`` rendered, ``failures`` (batches passed through after an
    error) and ``timeouts`` (requests answered with their own frame)."""

    def __init__(self, window_ms=3.0, max_batch=16, thickness=2,
                 device=None):
        self.device = resolve_device(device)
        self._cuda = self.device.type == 'cuda'
        self._window = window_ms / 1000.0
        self._max_batch = max_batch
        self._thickness = thickness
        self._queues = {}          # (h, w) -> Queue of _Request
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = {}
        self.batches = self.frames = self.failures = self.timeouts = 0

    def close(self, timeout=5.0):
        self._stop.set()
        with self._lock:
            threads = list(self._threads.values())
        for thread in threads:
            thread.join(timeout)

    def _count(self, **increments):
        with self._lock:
            for name, value in increments.items():
                setattr(self, name, getattr(self, name) + value)

    def _queue_for(self, shape):
        with self._lock:
            queue = self._queues.get(shape)
            if queue is None:
                queue = Queue()
                self._queues[shape] = queue
                thread = threading.Thread(
                    target=self._collector, args=(shape, queue),
                    name='render-{}x{}'.format(*shape), daemon=True)
                self._threads[shape] = thread
                thread.start()
            return queue

    def render(self, image_u8, boxes_px, classes, timeout=5.0):
        """Blocking: returns the rendered image (new array). boxes_px
        [N, 4] pixel ymin/xmin/ymax/xmax; classes [N] int32 (0 drops)."""
        request = _Request(image_u8, boxes_px, classes)
        self._queue_for(image_u8.shape[:2]).put(request)
        if not request.done.wait(timeout):
            self._count(timeouts=1)
            return image_u8        # renderer overloaded: pass through
        return request.result

    def _gather(self, queue):
        """The next batch of requests: the first, then whatever arrives
        within the window, up to max_batch; None when idle."""
        try:
            first = queue.get(timeout=0.2)
        except Empty:
            return None
        batch = [first]
        t0 = monotonic()
        while len(batch) < self._max_batch:
            remaining = self._window - (monotonic() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(queue.get(timeout=remaining))
            except Empty:
                break
        return batch

    def _collector(self, shape, queue):
        # the current device and inference mode are thread-local: this
        # thread enters both itself
        device_ctx = torch.cuda.device(self.device) if self._cuda \
            else contextlib.nullcontext()
        with device_ctx, torch.inference_mode():
            stream = torch.cuda.Stream(self.device) if self._cuda else None
            table = coco_color_table(self.device)
            index = pixel_index(*shape, self.device)
            staging = PinnedStaging(self._cuda)
            while not self._stop.is_set():
                batch = self._gather(queue)
                if batch is None:
                    continue
                try:
                    out = self._render_batch(batch, shape, stream, table,
                                             index, staging)
                except Exception:
                    _LOGGER.exception('Device render of %d frame(s) of %dx%d '
                                      'failed; passing them through',
                                      len(batch), shape[1], shape[0])
                    self._count(failures=1)
                    out = [request.image for request in batch]
                else:
                    self._count(batches=1, frames=len(batch))
                for request, result in zip(batch, out):
                    request.result = result
                    request.done.set()

    def _render_batch(self, batch, shape, stream, table, index, staging):
        """One device step for ``batch``: the rendered images, in order."""
        h, w = shape
        b = _bucket(len(batch))
        boxes = np.zeros((b, MAX_DETECTIONS, 4), np.float32)
        classes = np.zeros((b, MAX_DETECTIONS), np.int32)
        for i, request in enumerate(batch):
            m = min(len(request.boxes), MAX_DETECTIONS)
            boxes[i, :m] = request.boxes[:m]
            classes[i, :m] = request.classes[:m]
        host, _, copies = staging.fill([r.image for r in batch],
                                       (b, h, w, 3))
        if stream is None:
            out = render_boxes(host, torch.from_numpy(boxes),
                               torch.from_numpy(classes), table,
                               thickness=self._thickness, index=index)
            return list(out.numpy())
        with torch.cuda.stream(stream):
            images = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
            copies.append(event)
            out = render_boxes(images, torch.from_numpy(boxes).to(self.device),
                               torch.from_numpy(classes).to(self.device),
                               table, thickness=self._thickness, index=index)
            # one D2H a batch, into pinned memory from the caching host
            # allocator: each result is a view that keeps its block alive
            result = torch.empty(out.shape, dtype=torch.uint8,
                                 pin_memory=True)
            result.copy_(out, non_blocking=True)
        stream.synchronize()
        return list(result.numpy()[:len(batch)])


class DeviceDrawEffect:
    """Drop-in for DrawEffect: box geometry renders on the device (batched
    across cameras through a shared DeviceRenderer), labels are stamped on
    the host afterwards."""

    def __init__(self, renderer: DeviceRenderer, draw_labels=True):
        self._renderer = renderer
        self._draw_labels = draw_labels

    # copied from watsor_tpu/output/device_render.py:133-152
    def apply(self, frame_in, frame_out):
        detections = frame_out.detections_view()
        if not len(detections):
            return
        boxes = detections['bbox'].astype(np.float32)
        classes = detections['label'].astype(np.int32)
        rendered = self._renderer.render(frame_out.image, boxes, classes)
        np.copyto(frame_out.image, rendered)
        if self._draw_labels:
            import cv2
            for det in detections:
                style = get_coco_class(int(det['label']))
                y0, x0 = int(det['bbox'][0]), int(det['bbox'][1])
                text = '{} {:.0f}%'.format(
                    style.label, float(det['confidence']) * 100.0)
                cv2.putText(frame_out.image, text, (x0, max(y0 - 4, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, style.font_scale,
                            style.font_color, style.font_thickness,
                            cv2.LINE_AA)
