"""Kernel 1's share of its roofline: the least time its calls in the
traced slice could take (``work.fixed_point_work`` at the slice's buckets,
the watched classes and the NMS union) over their device time by kernel
name (fixed_point_kernel)."""

import numpy as np

from benchmark.lib import records, work


def read(rec):
    found = records.kernel(rec, 'fixed_point_kernel')
    buckets = records.slice_buckets(rec)
    if found is None or not len(buckets):
        return None
    calls, seconds = found
    cfg = rec['config']
    per_call = []
    for b in buckets:
        nbytes, ops = work.fixed_point_work(int(b), len(cfg['watched']),
                                            cfg['union'])
        per_call.append(work.Bound().add(nbytes, f32=ops).ms)
    return 100.0 * calls * float(np.mean(per_call)) / 1e3 / seconds
