"""The stages of the model's forward as the program's device-stamped spans
record them (``model.backbone``, ``model.fpn``, ``model.heads``: the
``device_ns`` of a span, the device's time between the two CUDA events
the span records on its stream), and the heads' operations a frame from
the configuration's plain reference (``stage_flops``). A program whose
spans carry no ``device_ns``, or that records no such span, gives None."""

import os

from benchmark.lib import spans, spec, work


def device_ms(rec, name):
    """The mean over the traced slice's batches of the device time of the
    program's spans named ``name`` (ms), or None."""
    totals = {}
    for s in spans.window(rec) or ():
        device_ns = getattr(s, 'device_ns', None)
        if s.name == name and device_ns is not None and s.batch is not None:
            totals[s.batch] = totals.get(s.batch, 0) + device_ns
    if not totals:
        return None
    return sum(totals.values()) / len(totals) / 1e6


def heads_mfu_pct(rec):
    """The heads' share of one H100's bf16 peak: their operations a frame
    (the reference's ``stage_flops``) times the padded frames of the
    slice's batches (``backend.dispatch``'s ``bucket``) over the device
    time of those batches' ``model.heads`` spans, or None."""
    found = spans.window(rec) or ()
    buckets = {s.batch: s.counts['bucket'] for s in found
               if s.name == 'backend.dispatch' and 'bucket' in s.counts}
    frames, seconds = 0, 0.0
    for s in found:
        device_ns = getattr(s, 'device_ns', None)
        if s.name == 'model.heads' and device_ns and s.batch in buckets:
            frames += buckets[s.batch]
            seconds += device_ns / 1e9
    if not seconds:
        return None
    cfg = rec['config']
    reference = spec.load_module(os.path.join(
        spec.BENCH_DIR, 'configs', cfg['reference'] + '.py'))
    flops = reference.stage_flops(cfg)['heads']
    return 100.0 * flops * frames / seconds / work.PEAK_OPS_S['bf16']
