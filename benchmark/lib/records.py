"""What the metric readers share: the window's batches before the traced
slice (all of them in an untraced run), the frames due there, and the
slice's device spans."""

import numpy as np

from benchmark.lib import stats


def batches(rec):
    """The record's batch columns, cut to the batches dispatched before
    the traced slice."""
    table = rec['batches']
    keep = table['dispatch0'] < rec['cut']
    return {name: column[keep] for name, column in table.items()}


def latencies_ms(rec):
    """Due-to-detections ms of every frame due before the cut."""
    keep = rec['due'] < rec['cut']
    return (rec['done'][keep] - rec['due'][keep]) * 1e3


def frames_per_s(rec):
    """Frames resolved per second over the window before the cut."""
    start, _ = rec['window']
    table = rec['batches']
    done = table['resolve1'] <= rec['cut']
    return stats.rate(table['frames'][done].sum(), start,
                      table['resolve1'][done].max())


def kernel(rec, fragment):
    """(calls, device seconds) of the slice's kernels whose name holds
    ``fragment``, or None without a trace or such a kernel."""
    trace = rec['trace']
    if trace is None:
        return None
    spans = [(s, e) for s, e, name in trace['device'] if fragment in name]
    if not spans:
        return None
    return len(spans), sum(e - s for s, e in spans) / 1e9


def slice_buckets(rec):
    """The padded batch of each batch dispatched within the slice."""
    table = rec['batches']
    return table['bucket'][table['dispatch0'] >= rec['cut']]


def busy_share(rec):
    """The share of the slice in which a kernel or a copy ran, or None
    without a trace or any device span in it."""
    trace = rec['trace']
    if trace is None or not trace['device']:
        return None
    start, end = trace['window_ns']
    return stats.busy_us(trace['device']) / (end - start)


def mean(values):
    return float(np.mean(values)) if len(values) else None
