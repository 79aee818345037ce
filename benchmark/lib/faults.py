"""Faults planted under the timed path, each of which the comparison has to
see (``correct`` false), each a context manager that patches the program's
``TorchDetectorBackend`` for its block:

- ``stale_state``: ``resolve`` hands back the last batch of the same size
  before this one (a step that returns its state unchanged);
- ``half_batch``: the second half of each batch's frames never reaches the
  model, which computes blank frames in their place (half of the batch
  left out);
- ``permuted_rows``: each frame gets the detections of the frame before
  it in its batch (answers handed to the wrong frames);
- ``altered_answer``: one served box of every frame moves (an answer
  altered where it is produced).
"""

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(name, wrap):
    from watsor_tpu_torch.detection.backend import TorchDetectorBackend
    original = getattr(TorchDetectorBackend, name)
    setattr(TorchDetectorBackend, name, wrap(original))
    try:
        yield
    finally:
        setattr(TorchDetectorBackend, name, original)


def stale_state():
    last = {}

    def wrap(resolve):
        def run(self, handle):
            result = resolve(self, handle)
            before = last.get(len(result[0]))
            last[len(result[0])] = result
            return result if before is None else before
        return run
    return _patched('resolve', wrap)


def half_batch():
    def wrap(dispatch):
        def run(self, images_u8, *args, **kwargs):
            frames = np.array(images_u8)
            frames[(len(frames) + 1) // 2:] = 0
            return dispatch(self, frames, *args, **kwargs)
        return run
    return _patched('dispatch', wrap)


def permuted_rows():
    def wrap(resolve):
        def run(self, handle):
            result = list(resolve(self, handle))
            for i in (0, 1, 2, 3, 5):
                if i < len(result):
                    result[i] = np.roll(result[i], 1, axis=0)
            return tuple(result)
        return run
    return _patched('resolve', wrap)


def altered_answer(shift=0.1):
    def wrap(resolve):
        def run(self, handle):
            result = resolve(self, handle)
            boxes, scores = result[0], result[1]
            for i in range(len(boxes)):
                rows = np.nonzero(scores[i] > 0)[0]
                if len(rows):
                    boxes[i, rows[0], 0::2] = np.clip(
                        boxes[i, rows[0], 0::2] + shift, 0.0, 1.0)
            return result
        return run
    return _patched('resolve', wrap)


FAULTS = {'stale_state': stale_state, 'half_batch': half_batch,
          'permuted_rows': permuted_rows, 'altered_answer': altered_answer}
