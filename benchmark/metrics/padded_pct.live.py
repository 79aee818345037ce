"""The share of the padded rows in the buckets of the traced slice's
batches: 100 x the sum of (bucket - frames) over the sum of buckets, from
the counts of the program's ``backend.dispatch`` spans."""

from benchmark.lib import spans


def read(rec):
    return spans.padded_pct(rec)
