"""The median, over every frame due before the traced slice, of the time
from its due time to the end of the resolve that returned its detections
(host clock)."""

from benchmark.lib import records, stats


def read(rec):
    values = records.latencies_ms(rec)
    return stats.percentile(values, 50) if len(values) else None
