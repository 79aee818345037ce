# Copy of watsor_tpu/output/http_stream.py: imports and paths adapted.
"""HTTP video streaming: MJPEG multipart and MPEG-TS chunk iterators with
per-request dynamic subscription.

Reference contract (upstream watsor/output/video.py:38-166): each
HTTP request subscribes its own depth-1 queue to the camera pipeline and
runs the role inline in the serving thread (Stub delegate); on disconnect
it unsubscribes and depletes the queue so ring slots return; MJPEG frames
are JPEG-encoded once per frame epoch into a cache shared by all viewers;
an idle tick emits an empty multipart part as keep-alive.
"""

import threading
from queue import Empty, Queue
from time import monotonic

from watsor_tpu_torch.runtime.tasks import Stub, WorkPublish

BOUNDARY = b'--frame'


class _JpegCache:
    """One JPEG per frame epoch, shared across all MJPEG viewers of the
    same camera (the reference keys its shared cache the same way,
    upstream watsor/output/video.py:120-132)."""

    def __init__(self, encode):
        self._encode = encode
        self._lock = threading.Lock()
        self._epoch = None
        self._data = b''

    def get(self, frame):
        epoch = frame.epoch
        with self._lock:
            if epoch != self._epoch:
                self._data = self._encode(frame.image)
                self._epoch = epoch
            return self._data

    def close(self):
        """Release the encode callable's native resources (if any)."""
        close = getattr(self._encode, 'close', None)
        if close is not None:
            with self._lock:
                close()


def default_jpeg_encode(image):
    try:
        from watsor_tpu_torch.io import native
        return native.jpeg_encode(image)
    except Exception:
        import cv2
        ok, data = cv2.imencode('.jpg', image[:, :, ::-1])
        return data.tobytes() if ok else b''


def _scaled_encode(out_hw, quality):
    """Encode callable for one (out_hw, quality) variant: a persistent
    native encoder (downscale fused into its swscale pass) when the native
    runtime is available, else cv2 resize + imencode."""
    try:
        from watsor_tpu_torch.io.native import JpegEncoder
    except Exception:
        JpegEncoder = None

    state = {}

    def encode(image):
        src_hw = image.shape[:2]
        if JpegEncoder is not None:
            enc = state.get('native')
            if enc is None or enc._src_hw != src_hw:
                if enc is not None:
                    enc.close()
                try:
                    state['native'] = enc = JpegEncoder(
                        src_hw, out_hw=out_hw, quality=quality)
                except Exception:
                    state['native'] = enc = None
            if enc is not None:
                return enc.encode(image)
        import cv2
        if out_hw is not None and tuple(out_hw) != tuple(src_hw):
            image = cv2.resize(image, (out_hw[1], out_hw[0]),
                               interpolation=cv2.INTER_AREA)
        ok, data = cv2.imencode('.jpg', image[:, :, ::-1],
                                [cv2.IMWRITE_JPEG_QUALITY, quality])
        return data.tobytes() if ok else b''

    def close():
        enc = state.pop('native', None)
        if enc is not None:
            enc.close()

    encode.close = close
    return encode


class JpegCacheSet:
    """Per-camera set of epoch-keyed JPEG caches, one per (out_hw, quality)
    variant. All viewers of the same camera at the same variant share one
    cache (encode-once-serve-many); distinct variants encode independently
    but the downscaled ones are bandwidth-bound, not DCT-bound.

    Bounded: at most ``max_variants`` live caches (LRU). Each variant
    holds a persistent native encoder (codec ctx + YUV frame + a
    source-sized output buffer, ~10 MB at 1080p), so an unbounded map
    would let a client sweeping ?quality/?scale values pin gigabytes —
    evicted variants close their encoder; a still-streaming viewer of an
    evicted variant keeps its reference alive and it is simply rebuilt
    for the next new viewer."""

    def __init__(self, max_variants=8):
        from collections import OrderedDict
        self._lock = threading.Lock()
        self._caches = OrderedDict()
        self._max_variants = max_variants

    def get_cache(self, out_hw=None, quality=80):
        key = (None if out_hw is None else tuple(out_hw), int(quality))
        with self._lock:
            cache = self._caches.get(key)
            if cache is None:
                cache = _JpegCache(_scaled_encode(out_hw, quality))
                self._caches[key] = cache
                while len(self._caches) > self._max_variants:
                    _, evicted = self._caches.popitem(last=False)
                    evicted.close()
            else:
                self._caches.move_to_end(key)
            return cache


class HttpStream(WorkPublish):
    """A per-request worker driven inline by response iteration: ``start``
    subscribes, ``__next__`` pulls one payload (or emits a keep-alive), and
    ``close`` unsubscribes and depletes the queue so no ring slot leaks."""

    def __init__(self, name, publisher, frame_buffer, stop_event=None):
        queue = Queue(1)
        self._publisher = publisher
        self._stub = None
        self._chunk = None
        super().__init__(name, queue, frame_buffer, stop_event)

    # Run inline (Stub), not as a thread.
    def initialize(self):
        self._stub = Stub(self)

    def start(self):
        self._stub.start()
        self._publisher.subscribe(self.frame_queue)

    def is_alive(self):
        return False

    def join(self, timeout=None):
        pass

    def close(self):
        self._publisher.unsubscribe(self.frame_queue)
        # deplete: confirm any payloads still queued so slots return
        while True:
            try:
                payload = self.frame_queue.get_nowait()
            except Empty:
                break
            self.frame_buffer.frames[payload.frame_index].latch.next()
        self._stub.close()

    def __iter__(self):
        self.start()
        return self

    def __next__(self):
        if self.stop_event.is_set():
            raise StopIteration
        self._chunk = None
        self._stub.step()          # Work._process: 1 s timeout then _no_frame
        return self._chunk if self._chunk is not None else self._keep_alive()

    def _keep_alive(self):
        return b''


class MotionJpeg(HttpStream):
    """multipart/x-mixed-replace JPEG stream.

    ``max_fps`` caps this viewer's delivery (and, because the shared cache
    is epoch-keyed, the encode rate when every viewer of the camera is
    capped): frames arriving inside the interval are released immediately
    without touching the encoder — a dashboard of many cameras at
    ``?fps=10`` costs a third of the reference's always-source-rate
    posture (upstream watsor/output/video.py:118-149) before the
    persistent-encoder and downscale savings."""

    def __init__(self, name, publisher, frame_buffer, jpeg_cache=None,
                 stop_event=None, max_fps=None):
        super().__init__(name, publisher, frame_buffer, stop_event)
        self._cache = jpeg_cache if jpeg_cache is not None \
            else _JpegCache(default_jpeg_encode)
        self._interval = 1.0 / max_fps if max_fps else 0.0
        self._last_emit = 0.0

    @property
    def mime_type(self):
        return 'multipart/x-mixed-replace; boundary=' + \
            BOUNDARY.decode().lstrip('-')

    def _new_frame(self, frame, payload):
        now = monotonic()
        if self._interval and now - self._last_emit < self._interval:
            frame.latch.next()        # skip: release without encoding
            return
        try:
            data = self._cache.get(frame)
        finally:
            frame.latch.next()
        self._last_emit = now
        self._chunk = (BOUNDARY + b'\r\n'
                       b'Content-Type: image/jpeg\r\n'
                       b'Content-Length: ' + str(len(data)).encode() +
                       b'\r\n\r\n' + data + b'\r\n')

    def _keep_alive(self):
        # empty part: keeps the connection warm while the camera is off
        return BOUNDARY + b'\r\n\r\n'


class MpegTS(HttpStream):
    """Raw MPEG-TS byte stream from the broadcast encoder's chunk ring."""

    mime_type = 'video/mp2t'

    def __init__(self, name, encoder, stop_event=None):
        self._ring = encoder.ts_ring
        super().__init__(name, encoder, self._ring.buffer, stop_event)

    def _new_frame(self, slot, payload):
        try:
            length = self._ring.lengths[payload.frame_index]
            self._chunk = slot.image.reshape(-1)[:length].tobytes()
        finally:
            slot.latch.next()
