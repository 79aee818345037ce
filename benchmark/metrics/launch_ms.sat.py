"""The mean host time a batch spends in the program's ``backend.step``
(the forward's and NMS's launches), ``backend.filters`` (the camera rows'
H2D and the filters) and ``backend.pack`` spans, over the batches of the
traced slice (the program's spans, time.time_ns). It includes the host's
waits on the card: a launch that blocks on a full launch queue, and the
rows' copy from pageable memory in ``backend.filters``, which waits for
the stream's work before it. Most of it can be such waits, not launch
overhead."""

from benchmark.lib import spans

STEP = ('backend.step', 'backend.filters', 'backend.pack')


def read(rec):
    return spans.per_batch_ms(rec, STEP)
