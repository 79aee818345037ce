"""The arithmetic of the metrics: rates over a whole window, percentiles
over every sample, the union of device intervals, and the spread of a set
of runs. ``busy_us`` is copied from watsor_tpu_torch/profile_step.py."""

import statistics

import numpy as np


def rate(count, start, end):
    """``count`` over the seconds from ``start`` to ``end``."""
    return count / (end - start)


def percentile(values, q):
    """The q-th percentile (linear between samples) of every value."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def busy_us(spans):
    """The union of the (start, end, ...) intervals, in their unit."""
    total, cur_start, cur_end = 0.0, None, None
    for s, e, *_ in sorted(spans):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def clip(spans, start, end):
    """The (start, end, name) spans cut to [start, end], empty ones out."""
    out = []
    for s, e, name in spans:
        s, e = max(s, start), min(e, end)
        if e > s:
            out.append((s, e, name))
    return out


def gaps(spans, start, end):
    """The (start, end) intervals of [start, end] that no span covers."""
    out, cursor = [], start
    for s, e, *_ in sorted(spans):
        if s > cursor:
            out.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(s, e) for s, e in out if e > s]


def spread(values):
    """The distance between the first and third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median
