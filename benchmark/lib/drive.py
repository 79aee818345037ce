"""The two ways the harness offers load to the backend, both with one batch
in flight ahead, as the application's detector task drives it
(watsor_tpu_torch/detection/detector.py ``ObjectDetector``: stage the
batch into a host array, ``dispatch``, then ``resolve`` the batch before):

- ``closed``: every camera's next frame in each batch, the next batch
  staged and dispatched as soon as the one before it was resolved, for the
  window's seconds;
- ``open``: frames fall due on a schedule fixed in advance (each camera at
  its frame rate, from a seeded phase) whatever the backend does. Batches
  form by the detector task's gather rule: wait for a frame (2 ms while a
  batch is in flight, and resolve that batch if none comes), then take
  more until the batch is full or the gather window after the first has
  passed. Every frame due in the window is served, after its close if need
  be.

Every batch's host times are recorded; each frame's result is checked for
shape and finite numbers (a frame that errors or comes back malformed is
``failed``), and a sample of frames, drawn from the seed, is kept for the
comparison with the reference.
"""

import heapq
import time

import numpy as np

from benchmark.lib import check

clock = time.perf_counter


class Record:
    """Host times of the window's batches (s, host clock), their frames and
    padded buckets, each frame's due and done times (open loop), failures,
    and the kept sample."""

    def __init__(self, sample_size, rng):
        self.batches = []           # (dispatch0, dispatch1, resolve0,
        # resolve1, frames, bucket, backlog)
        self.due, self.done = [], []
        self.attempted = 0
        self.failed = 0
        self.sample = []            # heap of (-key, order, item)
        self._size = sample_size
        self._rng = rng
        self._order = 0

    def keep(self, result, pool_rows, senders):
        """Offer a resolved batch's frames to the seeded sample."""
        keys = self._rng.random(len(pool_rows))
        for i, key in enumerate(keys):
            if len(self.sample) < self._size or key < -self.sample[0][0]:
                item = (check.served(result, i), int(pool_rows[i]),
                        senders[i])
                self._order += 1
                entry = (-key, self._order, item)
                if len(self.sample) < self._size:
                    heapq.heappush(self.sample, entry)
                else:
                    heapq.heapreplace(self.sample, entry)

    def kept(self):
        """The sample in the order its frames were served."""
        return [item for _, _, item in sorted(self.sample,
                                              key=lambda e: e[1])]

    def arrays(self):
        names = ('dispatch0', 'dispatch1', 'resolve0', 'resolve1', 'frames',
                 'bucket', 'backlog')
        table = np.asarray(self.batches, np.float64).reshape(-1, len(names))
        return {name: table[:, i] for i, name in enumerate(names)}


def well_formed(result, n, max_detections):
    """The resolved tuple has the contract's shapes and finite numbers."""
    try:
        boxes, scores, classes, valid = result[:4]
        return boxes.shape == (n, max_detections, 4) and \
            scores.shape == (n, max_detections) and \
            classes.shape == (n, max_detections) and valid.shape == (n,) \
            and bool(np.isfinite(boxes).all()) and \
            bool(np.isfinite(scores).all())
    except (TypeError, ValueError, AttributeError):
        return False


class Driver:
    """Drives ``backend`` with frames from ``pool`` [P, S, S, 3] (uint8,
    host), recording into ``record``; ``tracer`` profiles a slice."""

    def __init__(self, backend, pool, record, tracer, max_detections,
                 bucket):
        self.backend = backend
        self.pool = pool
        self.record = record
        self.tracer = tracer
        self.max_detections = max_detections
        self.bucket = bucket
        self.inflight = None

    def send(self, first, n, senders, backlog=0):
        """Dispatch the pool's rows ``first`` to ``first + n`` (a view: the
        harness copies no frame), then resolve the batch before; the new
        batch is in flight after."""
        rows = np.arange(first, first + n)
        t0 = clock()
        with self.tracer.span('bench.dispatch'):
            try:
                handle = self.backend.dispatch(self.pool[first:first + n],
                                               senders=senders)
            except Exception:
                handle = None
        t1 = clock()
        self.finish()
        self.inflight = (handle, rows, senders, t0, t1, backlog)

    def finish(self):
        """Resolve the batch in flight, if any; returns when it resolved."""
        if self.inflight is None:
            return None
        handle, rows, senders, t0, t1, backlog = self.inflight
        self.inflight = None
        n = len(rows)
        r0 = clock()
        with self.tracer.span('bench.resolve'):
            try:
                result = self.backend.resolve(handle) if handle else None
            except Exception:
                result = None
        r1 = clock()
        rec = self.record
        rec.batches.append((t0, t1, r0, r1, n, self.bucket(n), backlog))
        rec.attempted += n
        with self.tracer.span('bench.keep'):
            if result is None or not well_formed(result, n,
                                                 self.max_detections):
                rec.failed += n
            else:
                rec.keep(result, rows, senders)
        return r1

    def closed(self, batches, seconds):
        """Send ``batches(i)`` -> (first pool row, frames, senders) in turn
        for ``seconds``; returns (start, end) of the window: its first
        dispatch and the resolve of its last batch."""
        i = 0
        start = clock()
        self.tracer.arm(start, seconds)
        while True:
            now = clock()
            if now >= start + seconds:
                break
            self.tracer.tick(now)
            self.send(*batches(i))
            i += 1
        self.tracer.finish()
        end = self.finish()
        return start, end

    def open(self, due, senders, max_batch, gather_s, seconds):
        """Serve frames due at ``start + due[k]`` (ascending, all under
        ``seconds``), frame k being the pool's row k modulo its first
        ``len(pool) - max_batch`` rows (the pool repeats those rows past
        them, so that a batch is a view) from camera ``senders[k]``;
        returns (start, end): the schedule's origin and the resolve of the
        last batch. Fills the record's due and done times, a frame each."""
        n = len(due)
        start = clock()
        self.tracer.arm(start, seconds)
        due_at = start + np.asarray(due, np.float64)
        done = np.zeros(n)
        taken = 0
        batch_of = []               # (first, last) frame of each batch
        tracer = self.tracer
        period = len(self.pool) - max_batch

        def wait_for(timeout):
            """The next due frame's index within ``timeout`` s, else None
            after waiting it out."""
            now = clock()
            if taken < n and due_at[taken] <= now:
                return taken
            if taken < n and due_at[taken] - now <= timeout:
                with tracer.span('bench.wait'):
                    time.sleep(max(due_at[taken] - clock(), 0.0))
                return taken
            with tracer.span('bench.wait'):
                time.sleep(timeout)
            return None

        def finish():
            r1 = self.finish()
            if r1 is not None:
                first, last = batch_of.pop(0)
                done[first:last] = r1

        while taken < n:
            tracer.tick(clock())
            if clock() >= start + seconds:
                tracer.finish()
            first = wait_for(0.002 if self.inflight else 1.0)
            if first is None:
                finish()
                continue
            taken += 1
            deadline = clock() + gather_s
            while taken - first < max_batch:
                if taken < n and due_at[taken] <= clock():
                    taken += 1
                    continue
                remaining = deadline - clock()
                if remaining <= 0 or wait_for(remaining) is None:
                    break
                taken += 1
            backlog = int(np.searchsorted(due_at, clock(), 'right')) - taken
            batch_of.append((first, taken))
            self.send(first % period, taken - first, senders[first:taken],
                      backlog)
            if len(batch_of) > 1:
                # send() resolved the batch before this one
                f, last = batch_of.pop(0)
                done[f:last] = self.record.batches[-1][3]
        tracer.finish()
        finish()
        self.record.due, self.record.done = due_at, done
        return start, float(done.max()) if n else clock()
