"""Of the traced slice's device idle time (its gaps between kernels and
copies, torch.profiler), the share that falls inside the union of the
program's ``backend.fill`` spans, on the profiler's clock."""

from benchmark.lib import spans


def read(rec):
    return spans.idle_inside_pct(rec, 'backend.fill')
