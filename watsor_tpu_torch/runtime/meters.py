# Copy of watsor_tpu/runtime/meters.py: imports and paths adapted.
"""Telemetry primitives: sliding-window FPS meters, inference-time averages
and a token-bucket rate limiter.

Same observable behavior as the reference's meters
(upstream watsor/stream/share.py:131-283) — FPS over a 10 s sliding
window, average inference milliseconds, MQTT-controllable decoder throttling
— implemented with plain arrays + a mutex (single process, no shared ctypes).
"""

import threading
from time import time


class FramesPerSecond:
    """Frames per second over a sliding window of 1-second buckets.

    Call the instance (optionally with ``value=True``) to record a frame;
    read ``fps`` for the rate over the last ``window`` seconds.
    """

    def __init__(self, window=10):
        self._window = window
        self._lock = threading.Lock()
        # ring of (second_stamp, count) buckets
        self._buckets = [(0.0, 0)] * window

    def __call__(self, value=True):
        if not value:
            return value
        now = time()
        second = int(now)
        idx = second % self._window
        with self._lock:
            stamp, count = self._buckets[idx]
            if int(stamp) == second:
                self._buckets[idx] = (stamp, count + 1)
            else:
                self._buckets[idx] = (now, 1)
        return value

    @property
    def fps(self):
        # staleness by bucket SECOND, not first-event time: a bucket
        # whose second is >= window old would be overwritten by a
        # current frame at the same ring index, so it must not count
        # (otherwise a dead stream reports non-zero fps for an extra
        # second)
        second = int(time())
        with self._lock:
            total = sum(count for stamp, count in self._buckets
                        if second - int(stamp) < self._window)
        return total / self._window

    def reset(self):
        with self._lock:
            self._buckets = [(0.0, 0)] * self._window


class InferenceTime:
    """Average inference time in milliseconds over a sliding window."""

    def __init__(self, window=10):
        self._window = window
        self._lock = threading.Lock()
        self._buckets = [(0.0, 0, 0.0)] * window  # (stamp, n, total_ms)

    def __call__(self, ms):
        now = time()
        second = int(now)
        idx = second % self._window
        with self._lock:
            stamp, n, total = self._buckets[idx]
            if int(stamp) == second:
                self._buckets[idx] = (stamp, n + 1, total + ms)
            else:
                self._buckets[idx] = (now, 1, ms)

    @property
    def value(self):
        """Average milliseconds per inference, 0.0 when idle."""
        now = time()
        with self._lock:
            second = int(now)
            live = [b for b in self._buckets
                    if second - int(b[0]) < self._window]
            n = sum(b[1] for b in live)
            total = sum(b[2] for b in live)
        return total / n if n else 0.0


class LatencyMeter:
    """Sliding window of latency samples with percentile readout (the
    north-star frame->detection p50 rides on this; the reference exposes
    only average inference ms, SURVEY.md §5-tracing)."""

    def __init__(self, capacity=256):
        self._capacity = capacity
        self._lock = threading.Lock()
        self._samples = []
        self._index = 0

    def __call__(self, ms):
        with self._lock:
            if len(self._samples) < self._capacity:
                self._samples.append(ms)
            else:
                self._samples[self._index] = ms
                self._index = (self._index + 1) % self._capacity


    def percentile(self, q):
        with self._lock:
            if not self._samples:
                return 0.0
            ordered = sorted(self._samples)
        k = min(int(len(ordered) * q / 100.0), len(ordered) - 1)
        return ordered[k]

    @property
    def p50(self):
        return self.percentile(50)

    @property
    def p95(self):
        return self.percentile(95)


class RateLimiter:
    """Token-bucket limiter for decoder throttling (MQTT ``FPS = n``
    command). ``allow()`` consumes a token when limited; ``unlimited()``
    removes the cap (the sieve calls it on suspicious activity so detection
    never misses the action)."""

    UNLIMITED = -1

    def __init__(self, rate=UNLIMITED):
        self._lock = threading.Lock()
        self._rate = rate
        self._tokens = float(rate) if rate > 0 else 0.0
        self._last = time()

    def limit_rate(self, rate):
        with self._lock:
            self._rate = max(0, int(rate))
            self._tokens = min(self._tokens, float(self._rate))
            self._last = time()

    def unlimited(self):
        with self._lock:
            self._rate = self.UNLIMITED

    @property
    def rate(self):
        with self._lock:
            return self._rate

    def allow(self):
        with self._lock:
            if self._rate == self.UNLIMITED:
                return True
            if self._rate == 0:
                return False
            now = time()
            self._tokens = min(float(self._rate),
                               self._tokens + (now - self._last) * self._rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False
