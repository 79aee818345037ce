"""The mean time a batch's resolve waits for its step to finish on the
card (the program's ``backend.wait`` span), over the batches of the
traced slice: high where the card is behind the host, near 0 where the
host is behind the card (the program's spans, time.time_ns)."""

from benchmark.lib import spans


def read(rec):
    return spans.per_batch_ms(rec, ('backend.wait',))
