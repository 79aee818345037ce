# Copy of watsor_tpu/runtime/frames.py: imports and paths adapted.
"""Frame arena: ring buffers of numpy-backed frames with a 3-state ownership
protocol (READY -> DETECT -> PUBLISH -> READY).

This re-expresses the reference's shared-memory frame store
(upstream watsor/stream/share.py:35-128) and latch protocol
(upstream watsor/stream/sync.py:10-141) for a single-controller JAX
process: the pipeline runs as threads around one device, so plain
``threading`` primitives replace multiprocessing shared ctypes, and frames
are contiguous numpy slices of one arena so a whole camera batch can be
shipped host->HBM in a single transfer.

Protocol semantics preserved bit-for-bit (the reference's scheduler property
tests rely on them):

- ``StateLatch.next(n)`` confirms one unit of work; when the pending
  countdown reaches zero the state advances and the countdown for the *next*
  transition is armed with the max ``n`` passed by any confirmer.
- Frames stuck outside READY for longer than 30 s are forcibly reclaimed
  with a warning (self-healing against lost confirmations).
- Detections ride inside the frame header — there is no separate result
  channel.
"""

import logging
import threading
from enum import IntEnum
from time import monotonic, time

import numpy as np

MAX_DETECTIONS = 100
MAX_ZONES = 10

# Stale-frame reclamation threshold, matching the reference
# (upstream watsor/stream/share.py:103-112).
STALE_FRAME_SECONDS = 30.0

# One detection record: label index into COCO_CLASSES, confidence in [0, 1],
# bbox as (y_min, x_min, y_max, x_max) in pixels, triggered zone indices.
DETECTION_DTYPE = np.dtype([
    ('label', np.int32),
    ('confidence', np.float32),
    ('bbox', np.float32, (4,)),
    ('zones', np.int32, (MAX_ZONES,)),
    ('num_zones', np.int32),
])

HEADER_DTYPE = np.dtype([
    ('epoch', np.float64),          # wall-clock capture time
    ('num_detections', np.int32),
    ('detections', DETECTION_DTYPE, (MAX_DETECTIONS,)),
])


class State(IntEnum):
    """Frame ownership states, traversed cyclically."""

    READY = 1
    DETECT = 2
    PUBLISH = 3

    @staticmethod
    def next(s):
        return State.READY if s == State.PUBLISH else State(s + 1)


class CountDownLatch:
    """Block until a set of operations in other threads completes."""

    def __init__(self, count=1, lock=None):
        self._cond = threading.Condition(lock)
        self._count = count

    def reset(self, count):
        with self._cond:
            self._count = count

    def count_down(self):
        with self._cond:
            self._count -= 1
            if self._count <= 0:
                self._cond.notify_all()
            return self._count

    @property
    def count(self):
        with self._cond:
            return self._count

    def wait(self, timeout=None):
        with self._cond:
            return self._cond.wait_for(lambda: self._count <= 0, timeout)


class StateLatch:
    """Counted state transitions over the READY/DETECT/PUBLISH cycle.

    ``next(n)`` confirms one unit of work toward the pending transition and
    records ``n`` as a bid for the following transition's required
    confirmation count (the max bid wins). When the pending countdown reaches
    zero the state advances and the next countdown is armed.
    """

    def __init__(self, state=State.READY, lock=None):
        self._lock = lock if lock is not None else threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._state = state
        self._pending = 0      # confirmations still needed for the transition
        self._next_max = 0     # armed count for the transition after that

    def set_next(self, next_state_count_down):
        with self._cond:
            self._pending = next_state_count_down
            self._next_max = 0

    def next(self, next_state_count_down=0):
        with self._cond:
            old = self._state
            self._next_max = max(self._next_max, next_state_count_down)
            if self._pending <= 0 or self._pending == 1:
                # this confirmation completes the transition
                self._pending = self._next_max
                self._next_max = 0
                self._state = State.next(self._state)
            else:
                self._pending -= 1
            new = self._state
            self._cond.notify_all()
            return old, new

    def wait(self, state, timeout=None):
        with self._cond:
            return self._cond.wait_for(lambda: self._state == state, timeout)

    def wait_for(self, state, predicate, timeout=None):
        """Wait for ``state`` or until ``predicate()`` is true, polling the
        predicate at 1 s granularity (it may observe out-of-band stop
        events)."""
        with self._cond:
            result = self._state == state or predicate()
            if result:
                return result
            end_time = None if timeout is None else monotonic() + timeout
            while not result:
                wait_time = 1.0
                if end_time is not None:
                    wait_time = min(end_time - monotonic(), 1.0)
                    if wait_time <= 0:
                        break
                result = self._cond.wait_for(
                    lambda: self._state == state, wait_time) or predicate()
            return result

    @property
    def state(self):
        with self._cond:
            return self._state


class Frame:
    """One slot of a frame ring: header (epoch + in-band detections), an
    image view into the arena, an optional detect-resolution plane (filled
    by the decoder in the same swscale pass so the detection batch is a
    straight memcpy), and the ownership latch."""

    __slots__ = ('header', 'image', 'detect_plane', 'latch', 'lock')

    def __init__(self, image_view, lock=None, detect_view=None):
        self.lock = lock if lock is not None else threading.RLock()
        self.header = np.zeros((), dtype=HEADER_DTYPE)
        self.image = image_view
        self.detect_plane = detect_view
        self.latch = StateLatch(State.READY, self.lock)

    @property
    def epoch(self):
        return float(self.header['epoch'])

    def stamp(self, epoch=None):
        self.header['epoch'] = time() if epoch is None else epoch

    def clear(self):
        self.header['num_detections'] = 0

    def detections_view(self):
        n = int(self.header['num_detections'])
        return self.header['detections'][:n]

    def set_detections(self, records):
        n = min(len(records), MAX_DETECTIONS)
        self.header['detections'][:n] = records[:n]
        self.header['num_detections'] = n


class FrameBuffer:
    """A ring of frames backed by ONE contiguous arena.

    The arena layout [ring, height, width, 3] means a scheduler batching
    across cameras can address any subset of slots as numpy views and stage
    them into a device transfer without per-frame copies of headers.
    """

    def __init__(self, size, width, height, channels=3, detect_hw=None):
        self.arena = np.zeros((size, height, width, channels), dtype=np.uint8)
        self.detect_arena = None
        detect_views = [None] * size
        if detect_hw is not None:
            dh, dw = detect_hw
            self.detect_arena = np.zeros((size, dh, dw, channels), np.uint8)
            detect_views = [self.detect_arena[i] for i in range(size)]
        self.frames = [Frame(self.arena[i], detect_view=detect_views[i])
                       for i in range(size)]

    def __len__(self):
        return len(self.frames)

    def select_next_ready(self, start_index, timeout=None):
        """Cyclic scan for the next READY frame, starting after
        ``start_index``. Frames stuck outside READY for longer than
        STALE_FRAME_SECONDS are forcibly reclaimed. Returns the slot index or
        -1 when none became available within ``timeout``."""
        deadline = None if timeout is None else monotonic() + timeout
        while True:
            now = time()
            for step in range(1, len(self.frames) + 1):
                idx = (start_index + step) % len(self.frames)
                frame = self.frames[idx]
                if frame.latch.state == State.READY:
                    return idx
                age = now - frame.epoch
                if frame.epoch > 0 and age > STALE_FRAME_SECONDS:
                    logging.getLogger('watsor_tpu.frames').warning(
                        "Reclaiming frame %d stuck in %s for %.0fs",
                        idx, frame.latch.state.name, age)
                    frame.latch.set_next(0)
                    while frame.latch.state != State.READY:
                        frame.latch.next()
                    frame.stamp(0.0)
                    return idx
            if deadline is not None and monotonic() >= deadline:
                return -1
            if timeout == 0:
                return -1
            # brief backoff: rings are shallow, busy-wait would burn the core
            self.frames[(start_index + 1) % len(self.frames)].latch.wait(
                State.READY, 0.005)

    @property
    def fullness(self):
        """Share of frames NOT ready (0.0 = all slots free)."""
        ready = sum(1 for f in self.frames if f.latch.state == State.READY)
        return 1.0 - ready / len(self.frames)
