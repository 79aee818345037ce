"""The towers' and predictors' share of one H100's bf16 peak: their
operations a frame (the reference's ``stage_flops``) times the traced
slice's padded frames, over the device time of the slice's ``model.heads``
spans, over 989 TFLOP/s."""

from benchmark.lib import stages


def read(rec):
    return stages.heads_mfu_pct(rec)
