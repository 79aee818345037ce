"""The share of the traced slice in which no kernel and no copy ran on
the device (torch.profiler)."""

from benchmark.lib import records


def read(rec):
    busy = records.busy_share(rec)
    return None if busy is None else 100.0 * (1.0 - busy)
