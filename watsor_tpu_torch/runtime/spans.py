"""The program's spans and counts, recorded while a ``torch.profiler``
capture runs in the process and not otherwise.

``span(name, batch=None, **counts)`` is a context manager. With no capture
running it returns ``NULL``, one shared context that records nothing,
after one read of the profiler's flag. With a capture running, the span
records its name, its start and end, the span that encloses it on the same
thread, the batch it belongs to and its integer counts, and it opens a
``record_function`` of the same name, so that the capture's Chrome trace
shows the program's phases beside the kernels and copies.

Start and end are ``time.time_ns()``, the clock of the profiler's CPU
events: a span lies over the device trace's kernels and idle gaps as they
happened. ``batch=NEXT`` numbers a new batch; a span without a batch of
its own takes its parent's, and ``dispatch`` hands its number to
``resolve`` in the handle, so every span of one batch carries one number.

A span opened with ``device=`` a CUDA device also records a pair of
timing CUDA events on that device's current stream, around the work it
launches; none while the stream is being captured into a CUDA graph. The
span's ``device_ns`` is the time the device took from one event to the
other, resolved when ``records()`` is read once the device has passed
both (after the caller's synchronise); it is None for a span without
events, or whose events the device has not yet reached.

Finished spans go into a bounded deque, the oldest dropped first.
``records()`` returns a copy and ``clear()`` empties it; the benchmark's
traced run and ``/profiler`` read them.
"""

import collections
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65536
NEXT = object()   # span(..., batch=NEXT): number a new batch

Span = collections.namedtuple(
    'Span', 'id name start_ns end_ns parent batch counts device_ns',
    defaults=(None,))


class _Null:
    """The context ``span`` returns with no capture running."""

    __slots__ = ()
    id = None
    batch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts):
        """Counts found inside the span (none are kept)."""


NULL = _Null()


class _Open:
    """A span that records itself when it ends."""

    __slots__ = ('_recorder', 'name', 'id', 'batch', 'parent', 'counts',
                 '_start', '_mark', '_stream', '_events')

    def __init__(self, recorder, name, batch, counts, device):
        self._recorder = recorder
        self.name = name
        self.batch = batch
        self.counts = counts
        self._stream = _stream_of(device)
        self._events = None

    def count(self, **counts):
        """Counts found inside the span, added to those it opened with."""
        self.counts.update(counts)

    def __enter__(self):
        recorder = self._recorder
        stack = recorder._stack()
        parent = stack[-1] if stack else None
        self.id = next(recorder._ids)
        self.parent = parent.id if parent is not None else None
        if self.batch is NEXT:
            self.batch = next(recorder._batches)
        elif self.batch is None and parent is not None:
            self.batch = parent.batch
        stack.append(self)
        # the span holds its record_function's event: the event's stamps
        # fall early in its enter and late in its exit (made before the
        # start is read, so that no collection its allocation may set off
        # falls between the two)
        self._mark = _profiler.record_function(self.name)
        self._start = time.time_ns()
        self._mark.__enter__()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
        self._mark.__exit__(*exc)
        end = time.time_ns()
        recorder = self._recorder
        recorder._stack().pop()
        recorder._append(Span(self.id, self.name, self._start, end,
                              self.parent, self.batch, self.counts),
                         self._events)
        return False


def _stream_of(device):
    """The current stream of ``device`` to stamp, or None: no device, one
    that is not CUDA, or a stream being captured into a CUDA graph."""
    if device is None or torch.device(device).type != 'cuda' or \
            torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream(device)


class Recorder:
    """Spans of the process, at most ``capacity`` of them."""

    def __init__(self, capacity=CAPACITY):
        self._spans = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._batches = itertools.count(1)
        # {span id: (start event, end event)} of device stamps not resolved
        self._pending = {}

    def span(self, name, batch=None, device=None, **counts):
        """A span named ``name``: recorded while a profiler capture runs,
        else the shared ``NULL``; ``device`` (a CUDA device) stamps it on
        the device too."""
        if not _profiler._is_profiler_enabled:
            return NULL
        return _Open(self, name, batch, counts, device)

    def _stack(self):
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, record, events=None):
        with self._lock:
            self._spans.append(record)
            if events is not None:
                self._pending[record.id] = events

    def records(self):
        """The recorded spans, oldest first: a list of ``Span``, each
        device stamp the device has passed resolved into ``device_ns``."""
        with self._lock:
            out = list(self._spans)
            if self._pending:
                self._resolve(out)
            return out

    def _resolve(self, out):
        """Resolve the stamps in ``out`` (the deque's copy) the device has
        passed, in the copy and the deque; forget those that left it."""
        resolved = False
        for i, record in enumerate(out):
            events = self._pending.get(record.id)
            if events is None or not events[1].query():
                continue
            out[i] = record._replace(device_ns=round(
                events[0].elapsed_time(events[1]) * 1e6))
            resolved = True
        if resolved:
            self._spans = collections.deque(out, maxlen=self._spans.maxlen)
        self._pending = {record.id: self._pending[record.id] for record in out
                         if record.device_ns is None and
                         record.id in self._pending}

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._pending.clear()


def summary(records):
    """{name: {calls, total_ms, mean_ms, counts}} of ``records``, each
    count summed over the name's spans."""
    out = {}
    for record in records:
        entry = out.setdefault(record.name, {'calls': 0, 'total_ms': 0.0,
                                             'counts': {}})
        entry['calls'] += 1
        entry['total_ms'] += (record.end_ns - record.start_ns) / 1e6
        for key, value in record.counts.items():
            entry['counts'][key] = entry['counts'].get(key, 0) + value
    for entry in out.values():
        entry['mean_ms'] = entry['total_ms'] / entry['calls']
    return out


RECORDER = Recorder()
span = RECORDER.span
records = RECORDER.records
clear = RECORDER.clear
