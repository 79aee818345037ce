"""The mean frames a dispatched batch holds before the backend pads it to
its bucket, over the window's batches before the traced slice (the
harness's gather rule, copied from the detector task)."""

from benchmark.lib import records


def read(rec):
    return records.mean(records.batches(rec)['frames'])
