# Copy of watsor_tpu/filters/sieve.py: imports and paths adapted.
"""The detection sieve: single PUBLISH-stage gatekeeper per camera.

Reference semantics (upstream watsor/filter/sieve.py:7-52): runs as
the sole consumer of the camera's post-detection queue (it re-arms the
latch, so it MUST be the only latch-setter — work.py:117-121 in the
reference); copies detections out of the frame header, runs the filter
cascade, writes the survivors back in place, and lifts the decoder's rate
limit when suspicious activity appears so detection never misses the
action.
"""

from time import time

from watsor_tpu_torch.runtime.meters import FramesPerSecond, LatencyMeter
from watsor_tpu_torch.runtime.tasks import WorkPassthroughPublish


class DetectionSieve(WorkPassthroughPublish):

    def __init__(self, name, frame_queue, frame_buffer, track_filter,
                 rate_limiter=None, stop_event=None):
        self._track_filter = track_filter
        self._rate_limiter = rate_limiter
        self.fps = FramesPerSecond()
        # frame capture -> filtered detections published (the camera's
        # end-to-end analysis latency; detector latency covers only the
        # device step share)
        self.latency = LatencyMeter()
        super().__init__(name, frame_queue, frame_buffer, stop_event)

    def _incoming_frame(self, frame):
        detections = frame.detections_view().copy()
        kept, suspicious = self._track_filter(detections, frame.image.shape)
        if suspicious and self._rate_limiter is not None:
            # action in view: remove any MQTT-imposed FPS cap immediately
            self._rate_limiter.unlimited()
        frame.set_detections(kept)
        if frame.epoch > 0:
            self.latency((time() - frame.epoch) * 1000.0)
        self.fps(True)
