# Copy of watsor_tpu/runtime/tasks.py: imports and paths adapted.
"""Pipeline task roles: restartable spinning threads with the
READY/DETECT/PUBLISH frame ownership protocol.

Re-designs the reference's Spin/Read/Work/Publish hierarchy
(upstream watsor/stream/{spin,read,work}.py) for a single-controller
JAX process: every role is a thread (JAX owns the devices; nothing needs to
cross a process boundary), so roles hold their collaborators as plain
attributes instead of threading pickled args through a spawn boundary.

Protocol guarantees preserved (the reference's scheduler tests pin them):

- producers never block: a full queue means the frame is dropped;
- a frame sent for detection arms two confirmations (detector + publisher)
  before subscribers may touch it, then one per subscriber before the slot
  returns to the ring;
- a missing/slow subscriber's confirmation is padded immediately so slots
  are never leaked.
"""

import logging
import threading
from collections import namedtuple
from queue import Empty, Full

from watsor_tpu_torch.runtime.channel import Publish
from watsor_tpu_torch.runtime.frames import State

Payload = namedtuple('Payload', ['sender', 'frame_index'])


class Task:
    """A restartable spinning thread: `start` launches the loop, `terminate`
    signals the shared stop event, `initialize` re-creates the thread after
    death so a watchdog can resurrect it."""

    def __init__(self, name, stop_event=None, daemon=True):
        self.name = name
        self.stop_event = stop_event if stop_event is not None else threading.Event()
        self._daemon = daemon
        self._logger = logging.getLogger(self.__class__.__name__)
        self._thread = None
        self.initialize()

    def initialize(self):
        assert self._thread is None or not self._thread.is_alive(), \
            "{} has not terminated yet".format(self.name)
        self._spin_done = False
        self._thread = threading.Thread(
            name=self.name, target=self._run, daemon=self._daemon)

    def _end_spin(self):
        """End this spin WITHOUT marking the task shut down: the thread
        exits, and the watchdog will re-initialize and restart it (the
        decoder's EOF -> reconnect loop uses this)."""
        self._spin_done = True

    def _run(self):
        try:
            self._on_start()
            while not self.stop_event.is_set() and not self._spin_done:
                self._process()
        except Exception:
            self._logger.exception('Spin failure')
        finally:
            self._on_stop()

    def _on_start(self):
        pass

    def _on_stop(self):
        pass

    def _process(self):
        raise NotImplementedError

    def start(self):
        self._thread.start()

    def terminate(self):
        self.stop_event.set()

    def join(self, timeout=None):
        try:
            self._thread.join(timeout)
        except RuntimeError:
            pass       # never started (e.g. shutdown during start gating)

    def is_alive(self):
        return self._thread.is_alive()

    def is_shutdown(self):
        return self.stop_event.is_set()


class Stub:
    """Runs a role inline inside an already-running thread (e.g. an HTTP
    worker serving an MJPEG request): `start` performs setup only and
    `_process` is driven by the caller's iteration."""

    def __init__(self, task):
        self._task = task

    def start(self):
        self._task._on_start()

    def step(self):
        return self._task._process()

    def close(self):
        self._task._on_stop()


class Read(Task):
    """Produce frames into a queue, dropping when the consumer is busy."""

    def __init__(self, name, frame_queue, stop_event=None):
        self.frame_queue = frame_queue
        super().__init__(name, stop_event)

    def _process(self):
        frame = self._next_frame()
        if frame is None:
            return
        self._send_frame(frame)

    def _next_frame(self):
        return None

    def _send_frame(self, frame):
        try:
            self.frame_queue.put_nowait(frame)
        except Full:
            pass


class ReadFrameBuffer(Read):
    """A reader that owns a ring buffer: acquires the next READY slot, lets
    the subclass fill it (`_new_frame`), and transmits only the slot index."""

    def __init__(self, name, frame_queue, frame_buffer, stop_event=None):
        self.frame_buffer = frame_buffer
        self._last_frame_index = -1
        super().__init__(name, frame_queue, stop_event)

    def _next_frame(self):
        index = self.frame_buffer.select_next_ready(self._last_frame_index,
                                                    timeout=1.0)
        if index < 0:
            return None
        self._last_frame_index = index
        frame = self.frame_buffer.frames[index]
        return index if self._new_frame(frame) else None

    def _new_frame(self, frame):
        """Fill the READY slot; return True to transmit it."""
        return False


class ReadPublish(ReadFrameBuffer, Publish):
    """Fan a filled frame straight out to subscribers (no detection): the
    frame goes READY -> DETECT -> PUBLISH immediately with one confirmation
    per subscriber armed for the trip back to READY."""

    def __init__(self, name, frame_buffer, stop_event=None):
        ReadFrameBuffer.__init__(self, name, None, frame_buffer, stop_event)
        Publish.__init__(self)

    def _send_frame(self, frame_index):
        with self._subscribers_lock:
            max_subscribers = len(self._subscribers)
            if max_subscribers == 0:
                return
            frame = self.frame_buffer.frames[frame_index]
            payload = Payload(self.name, frame_index)

            frame.latch.next()                   # READY -> DETECT
            frame.latch.next(max_subscribers)    # DETECT -> PUBLISH, arm fan-in

            count = self._publish(payload)
            while count < max_subscribers:       # pad confirmations for busy subscribers
                frame.latch.next()
                count += 1


class ReadDetectPublish(ReadFrameBuffer, Publish):
    """The camera pipeline head: enqueue the slot index for detection AND
    announce it to subscribers. Two confirmations (detector done, publishing
    done) gate DETECT -> PUBLISH; then one per reached subscriber gates the
    return to READY."""

    def __init__(self, name, frame_queue, frame_buffer, stop_event=None):
        ReadFrameBuffer.__init__(self, name, frame_queue, frame_buffer, stop_event)
        Publish.__init__(self)

    def _send_frame(self, frame_index):
        with self._subscribers_lock:
            max_subscribers = len(self._subscribers)
            if max_subscribers == 0:
                return
            frame = self.frame_buffer.frames[frame_index]
            payload = Payload(self.name, frame_index)

            frame.latch.next(2)  # READY -> DETECT; detector + publisher confirm
            try:
                self.frame_queue.put_nowait(payload)
            except Full:
                # Detectors saturated: cycle the slot back to READY (drop).
                while not frame.latch.wait(State.READY, 0):
                    frame.latch.next()
                return

            count = self._publish(payload)
            frame.latch.next(count)   # publisher confirmation; arm fan-in count
            if count == 0:
                frame.latch.next()    # nobody listening: release immediately


class Work(Task):
    """Consume payloads from a queue with a 1 s timeout; `_no_frame` runs on
    idle ticks (used e.g. to keep MQTT sensor topics fresh)."""

    def __init__(self, name, frame_queue, stop_event=None):
        self.frame_queue = frame_queue
        super().__init__(name, stop_event)

    def _process(self):
        try:
            payload = self.frame_queue.get(timeout=1)
        except Empty:
            return self._no_frame()
        if payload is not None:
            return self._next_frame(payload)

    def _no_frame(self):
        pass

    def _next_frame(self, payload):
        pass


class WorkPublish(Work):
    """A worker on a shared ring: waits for the frame to reach PUBLISH (i.e.
    detection finished) before processing, then confirms the slot's return."""

    FRAME_WAIT_SECONDS = 10

    def __init__(self, name, frame_queue, frame_buffer, stop_event=None):
        self.frame_buffer = frame_buffer
        super().__init__(name, frame_queue, stop_event)

    def _next_frame(self, payload):
        frame = self.frame_buffer.frames[payload.frame_index]
        if not frame.latch.wait_for(State.PUBLISH, self.stop_event.is_set,
                                    self.FRAME_WAIT_SECONDS):
            self._logger.error("Frame %s missed", payload.frame_index)
            return
        if self.stop_event.is_set():
            return
        self._new_frame(frame, payload)

    def _new_frame(self, frame, payload):
        frame.latch.next()


class WorkInOutPublish(WorkPublish, Publish):
    """Copy/transform a frame from an input ring to an output ring and fan
    the output out to subscribers (the visual-effects stage). With no
    subscribers the input frame is released untouched — effects only run
    while someone is watching."""

    def __init__(self, name, frame_queue, frame_buffer_in, frame_buffer_out,
                 stop_event=None):
        self.frame_buffer_out = frame_buffer_out
        self._last_out_index = -1
        WorkPublish.__init__(self, name, frame_queue, frame_buffer_in, stop_event)
        Publish.__init__(self)

    def _new_frame(self, frame_in, payload):
        with self._subscribers_lock:
            try:
                max_subscribers = len(self._subscribers)
                if max_subscribers == 0:
                    return

                out_index = self.frame_buffer_out.select_next_ready(
                    self._last_out_index, timeout=1.0)
                if out_index < 0:
                    # output ring exhausted (stalled subscribers pin the
                    # slots): drop this frame and keep serving — dying
                    # here would stop rendering for EVERY viewer until
                    # the watchdog's next tick
                    self._logger.warning(
                        'No READY output slot; dropping frame')
                    return
                self._last_out_index = out_index
                frame_out = self.frame_buffer_out.frames[out_index]

                self._incoming_frame(frame_in, frame_out)

                frame_out.latch.next()                   # READY -> DETECT
                frame_out.latch.next(max_subscribers)    # DETECT -> PUBLISH

                count = self._publish(Payload(self.name, out_index))
                while count < max_subscribers:
                    frame_out.latch.next()
                    count += 1
            finally:
                frame_in.latch.next()  # always release the input slot

    def _incoming_frame(self, frame_in, frame_out):
        pass


class WorkPassthroughPublish(WorkPublish, Publish):
    """The single PUBLISH-stage gatekeeper (the detection sieve): processes
    the frame in place and re-arms the latch with the subscriber count, so it
    MUST be the only consumer of its queue."""

    def __init__(self, name, frame_queue, frame_buffer, stop_event=None):
        WorkPublish.__init__(self, name, frame_queue, frame_buffer, stop_event)
        Publish.__init__(self)

    def _new_frame(self, frame, payload):
        with self._subscribers_lock:
            max_subscribers = len(self._subscribers)
            if max_subscribers == 0:
                frame.latch.next()
                return

            self._incoming_frame(frame)

            frame.latch.set_next(max_subscribers)
            count = self._publish(payload)
            while count < max_subscribers:
                frame.latch.next()
                count += 1

    def _incoming_frame(self, frame):
        pass
