"""frame_latency_p95_ms: the 95th percentile, over every frame due in the
window, of the time from its due time to the end of the resolve that
returned its detections (host clock)."""

from benchmark.lib import records, stats


def read(rec):
    values = records.latencies_ms(rec)
    return stats.percentile(values, 95) if len(values) else None
