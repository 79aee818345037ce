"""The program's own spans (watsor_tpu_torch/runtime/spans.py), which the
program records while the traced slice's profiler runs, read in the same
process after the window. Only the spans that start inside the slice
count: the traced warm-up's fall before it. A program without the
recorder, or a run without a trace, gives None."""

from benchmark.lib import stats


def window(rec):
    """The program's spans that start inside the traced slice, or None."""
    if rec['trace'] is None:
        return None
    try:
        from watsor_tpu_torch.runtime import spans
    except ImportError:
        return None
    start, end = rec['trace']['window_ns']
    found = [s for s in spans.records() if start <= s.start_ns < end]
    return found or None


def per_batch_ms(rec, names):
    """The mean over the slice's batches of the time a batch spent in the
    spans named ``names`` (ms), or None where none was recorded."""
    totals = {}
    for s in window(rec) or ():
        if s.name in names and s.batch is not None:
            totals[s.batch] = totals.get(s.batch, 0) + s.end_ns - s.start_ns
    if not totals:
        return None
    return sum(totals.values()) / len(totals) / 1e6


def idle_inside_pct(rec, name):
    """Of the slice's device idle time, the share inside the union of the
    spans named ``name`` (%), or None without device events or such
    spans."""
    found = window(rec)
    trace = rec['trace']
    if not found or not trace['device']:
        return None
    inside = [(s.start_ns, s.end_ns) for s in found if s.name == name]
    gaps = stats.gaps(trace['device'], *trace['window_ns'])
    idle = stats.busy_us(gaps)
    if not inside or not idle:
        return None
    covered = idle + stats.busy_us(inside) - stats.busy_us(gaps + inside)
    return 100.0 * covered / idle


def padded_pct(rec):
    """100 x the padded rows over the buckets of the slice's dispatches
    (their ``frames`` and ``bucket`` counts), or None."""
    counts = [s.counts for s in window(rec) or ()
              if s.name == 'backend.dispatch']
    buckets = sum(c['bucket'] for c in counts)
    if not buckets:
        return None
    return 100.0 * sum(c['bucket'] - c['frames'] for c in counts) / buckets
