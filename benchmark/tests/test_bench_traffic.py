"""The traffic generator: every seed offers the same arrivals in another
order, a batch is a view of the frame pool, and the gather rule of the
open loop on a fake backend."""

import numpy as np
import torch

from benchmark.lib import cell, drive, trace


def test_every_seed_offers_the_same_arrivals():
    traffic = {'cameras': 12, 'fps': 30, 'pool_frames': 16}
    due_a, senders_a = cell.schedule(traffic, 2.0, np.random.default_rng(1))
    due_b, senders_b = cell.schedule(traffic, 2.0,
                                     np.random.default_rng(2 ** 31 + 9))
    assert len(due_a) == 12 * 60
    np.testing.assert_allclose(due_a, due_b)
    assert senders_a != senders_b
    assert (np.diff(due_a) >= 0).all() and due_a.max() < 2.0
    for name in set(senders_a):
        own = due_a[[s == name for s in senders_a]]
        np.testing.assert_allclose(np.diff(own), 1 / 30)


def test_open_pool_repeats_its_head_so_batches_are_views():
    traffic = {'loop': 'open', 'pool_frames': 10, 'max_batch': 4}
    pool = cell.frame_pool(traffic, 8, torch.Generator().manual_seed(3),
                           torch.device('cpu'))
    assert pool.shape == (14, 8, 8, 3)
    np.testing.assert_array_equal(pool[10:], pool[:4])


class FakeBackend:
    """Resolves each batch ``step_s`` after its dispatch."""

    def __init__(self, step_s):
        self.step_s = step_s
        self.sizes = []

    def dispatch(self, images, senders=None):
        self.sizes.append(len(images))
        return (len(images), drive.clock() + self.step_s)

    def resolve(self, handle):
        n, ready = handle
        while drive.clock() < ready:
            pass
        z = np.zeros((n, 100))
        return (np.zeros((n, 100, 4)), z, z.astype(np.int32),
                np.zeros(n, np.int32), 0.0)


def test_open_loop_gathers_due_frames_and_serves_all_of_them():
    traffic = {'cameras': 40, 'fps': 30, 'pool_frames': 16}
    due, senders = cell.schedule(traffic, 1.0, np.random.default_rng(5))
    backend = FakeBackend(0.02)
    pool = np.zeros((16 + 64, 2, 2, 3), np.uint8)
    record = drive.Record(4, np.random.default_rng(0))
    start, end = drive.Driver(backend, pool, record, trace.Slice(), 100,
                              cell.bucket).open(due, senders, 64, 0.004,
                                                1.0)
    assert sum(backend.sizes) == len(due) == record.attempted
    assert record.failed == 0
    latency = record.done - record.due
    assert (latency > 0).all() and latency.max() < 0.2
    # 1,200 frames/s against a 20 ms step: batches of tens of frames
    assert 10 < np.mean(backend.sizes) <= 64
    assert end == record.done.max() and end - start < 1.3
