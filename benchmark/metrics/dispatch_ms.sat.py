"""The mean host time of the backend's dispatch a batch (staging fill,
H2D and the step's launches), over the window's batches before the traced
slice (host clock)."""

from benchmark.lib import records


def read(rec):
    table = records.batches(rec)
    return records.mean((table['dispatch1'] - table['dispatch0']) * 1e3)
