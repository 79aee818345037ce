"""The mean time a batch spends in the program's ``backend.fill`` span,
the copy of its frames into the staging tensor and the zero padding, over
the batches of the traced slice (the program's spans, time.time_ns)."""

from benchmark.lib import spans


def read(rec):
    return spans.per_batch_ms(rec, ('backend.fill',))
