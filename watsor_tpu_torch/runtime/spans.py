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

Finished spans go into a bounded deque, the oldest dropped first.
``records()`` returns a copy and ``clear()`` empties it; the benchmark's
traced run and ``/profiler`` read them.
"""

import collections
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

CAPACITY = 65536
NEXT = object()   # span(..., batch=NEXT): number a new batch

Span = collections.namedtuple(
    'Span', 'id name start_ns end_ns parent batch counts')


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
                 '_start', '_mark')

    def __init__(self, recorder, name, batch, counts):
        self._recorder = recorder
        self.name = name
        self.batch = batch
        self.counts = counts

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
        # fall early in its enter and late in its exit
        self._start = time.time_ns()
        self._mark = _profiler.record_function(self.name)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        self._mark.__exit__(*exc)
        end = time.time_ns()
        recorder = self._recorder
        recorder._stack().pop()
        recorder._append(Span(self.id, self.name, self._start, end,
                              self.parent, self.batch, self.counts))
        return False


class Recorder:
    """Spans of the process, at most ``capacity`` of them."""

    def __init__(self, capacity=CAPACITY):
        self._spans = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._batches = itertools.count(1)

    def span(self, name, batch=None, **counts):
        """A span named ``name``: recorded while a profiler capture runs,
        else the shared ``NULL``."""
        if not _profiler._is_profiler_enabled:
            return NULL
        return _Open(self, name, batch, counts)

    def _stack(self):
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, record):
        with self._lock:
            self._spans.append(record)

    def records(self):
        """The recorded spans, oldest first: a list of ``Span``."""
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()


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
