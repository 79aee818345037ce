"""The device's busy time in the traced slice (the union of its kernels'
and copies' intervals) over the batches dispatched in it (torch.profiler)."""

from benchmark.lib import records, stats


def read(rec):
    steps = len(records.slice_buckets(rec))
    if rec['trace'] is None or not rec['trace']['device'] or not steps:
        return None
    return stats.busy_us(rec['trace']['device']) / 1e6 / steps
