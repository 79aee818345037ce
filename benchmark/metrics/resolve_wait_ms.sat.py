"""The mean host time of the backend's resolve a batch (the wait for the
card, the copy back, unpacking and the zone refiner), over the window's
batches before the traced slice (host clock)."""

from benchmark.lib import records


def read(rec):
    table = records.batches(rec)
    return records.mean((table['resolve1'] - table['resolve0']) * 1e3)
