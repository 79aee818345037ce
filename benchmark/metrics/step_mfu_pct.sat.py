"""The detect step's share of one H100's bf16 peak: the forward's FLOPs a
frame (FlopCounterMode over the reference's forward at batch 1) times the
frames resolved per second before the traced slice, over 989 TFLOP/s."""

from benchmark.lib import records, work


def read(rec):
    return 100.0 * rec['flops_per_frame'] * records.frames_per_s(rec) / \
        work.PEAK_OPS_S['bf16']
