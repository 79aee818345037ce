# Copy of watsor_tpu/io/synthetic.py; only its imports differ.
"""Synthetic camera sources: ``synthetic://shapes`` and
``synthetic://loop`` inputs.

Serves two purposes, mirroring the reference's Artist fixture strategy
(SURVEY.md §4): demo/verification without any camera or video file, and
load generation for benchmarks. ``shapes`` draws random moving shapes per
frame and fills the detect-resolution plane exactly as the native decoder
would; ``loop`` pre-renders a short sequence once and cycles it with
plain copies — the cheap high-stream-count load generator (a stand-in
for camera input on hosts without decode cores, e.g. the 32-camera
north-star experiment of BASELINE.json config #5).
"""

import cv2
import numpy as np

from watsor_tpu_torch.runtime.meters import FramesPerSecond, RateLimiter
from watsor_tpu_torch.testing.shapes import Artist


class SyntheticDecoder(Artist):
    """Drop-in replacement for VideoDecoder driven by the Artist painter."""

    def __init__(self, name, frame_queue, frame_buffer, stop_event=None,
                 fps=30, seed=None, rate_limiter=None):
        self.rate_limiter = rate_limiter if rate_limiter is not None \
            else RateLimiter()
        self.fps = FramesPerSecond()
        super().__init__(name, frame_queue, frame_buffer, stop_event,
                         fps=fps, seed=seed)

    def _new_frame(self, frame):
        if not super()._new_frame(frame):
            return False
        if not self.rate_limiter.allow():
            return False
        if frame.detect_plane is not None:
            dh, dw = frame.detect_plane.shape[:2]
            cv2.resize(frame.image, (dw, dh), dst=frame.detect_plane,
                       interpolation=cv2.INTER_LINEAR)
        self.fps(True)
        return True


def make_synthetic_decoder(url, name, frame_queue, frame_buffer,
                           stop_event=None, rate_limiter=None):
    """Build the decoder for a ``synthetic://<kind>[?seed=N]`` input URL.

    Kinds: ``shapes`` (per-frame drawing), ``loop`` (pre-rendered cycle),
    ``static`` (ONE pre-rendered frame repeated — the deterministic source
    for application-level equality tests). ``seed`` pins the artist RNG so
    two application runs draw identical content."""
    from urllib.parse import parse_qs

    kind, _, query = url[len('synthetic://'):].partition('?')
    params = parse_qs(query)
    seed = int(params['seed'][0]) if 'seed' in params else None
    cls = {'loop': LoopDecoder, 'static': StaticDecoder}.get(
        kind, SyntheticDecoder)
    return cls(name, frame_queue, frame_buffer, stop_event=stop_event,
               seed=seed, rate_limiter=rate_limiter)


class LoopDecoder(SyntheticDecoder):
    """``synthetic://loop``: pre-rendered drifting-shape frames cycled by
    copy — per-frame host cost is two memcpys (image + detect plane), so
    many 1080p streams can be generated on few host cores."""

    SEQUENCE = 24

    def __init__(self, name, frame_queue, frame_buffer, stop_event=None,
                 fps=30, seed=None, rate_limiter=None):
        super().__init__(name, frame_queue, frame_buffer, stop_event,
                         fps=fps, seed=seed, rate_limiter=rate_limiter)
        self._frames = None
        self._cursor = 0

    def _prerender(self, shape, detect_shape):
        frames = []
        image = np.empty(shape, np.uint8)

        class _Slot:    # minimal stand-in for Artist._new_frame's frame
            detect_plane = None

            def __init__(self, img):
                self.image = img

            def clear(self):
                pass

            def stamp(self):
                pass

        period, self._period = self._period, 0.0  # no pacing while drawing
        for _ in range(self.SEQUENCE):
            slot = _Slot(image)
            Artist._new_frame(self, slot)
            detect = None
            if detect_shape is not None:
                dh, dw = detect_shape[:2]
                detect = cv2.resize(image, (dw, dh),
                                    interpolation=cv2.INTER_LINEAR)
            frames.append((image.copy(), detect))
        self._period = period
        return frames

    def _new_frame(self, frame):
        if self._frames is None:
            detect_shape = None if frame.detect_plane is None \
                else frame.detect_plane.shape
            self._frames = self._prerender(frame.image.shape, detect_shape)
        self.stop_event.wait(self._period)
        if self.stop_event.is_set():
            return False
        if not self.rate_limiter.allow():
            return False
        image, detect = self._frames[self._cursor]
        self._cursor = (self._cursor + 1) % len(self._frames)
        np.copyto(frame.image, image)
        if detect is not None and frame.detect_plane is not None:
            np.copyto(frame.detect_plane, detect)
        frame.clear()
        frame.stamp()
        self.fps(True)
        return True


class StaticDecoder(LoopDecoder):
    """``synthetic://static``: one pre-rendered seeded frame repeated
    forever. Every frame carries identical pixels, so any two application
    runs over the same seed are comparable detection-for-detection — the
    determinism the fleet-vs-single-device application equality test needs
    (tests/test_fleet_app.py)."""

    SEQUENCE = 1
