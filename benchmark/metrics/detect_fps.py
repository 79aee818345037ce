"""detect_fps: frames resolved over the whole window, from its first
dispatch to the resolve of its last batch (host clock)."""

from benchmark.lib import stats


def read(rec):
    table = rec['batches']
    start, end = rec['window']
    return stats.rate(float(table['frames'].sum()), start, end)
