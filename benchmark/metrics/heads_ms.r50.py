"""The mean device time a batch of the program's ``model.heads`` span (the
time between the CUDA events it records on its stream) over the batches
of the traced slice, in ms."""

from benchmark.lib import stages


def read(rec):
    return stages.device_ms(rec, 'model.heads')
