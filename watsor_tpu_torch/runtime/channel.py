# Copy of watsor_tpu/runtime/channel.py: imports and paths adapted.
"""Inter-stage channels: drop-on-full queues, fairness-balanced queues and
the pub/sub registry.

Behavioral contract from the reference (upstream watsor/stream/
sync.py:144-204, publish.py:5-44): all inter-stage queues have capacity 1 and
producers never block — a busy consumer simply misses the frame
(latest-frame-wins). `BalancedQueue` adds per-sender in-flight quotas so one
camera can never starve another when sharing a consumer.
"""

import threading
from collections import Counter
from queue import Full, Queue


class BalancedQueue:
    """Wraps a queue with a per-sender semaphore so each sender has at most
    a fixed number of messages in flight; `put` raises Full when the sender's
    quota is exhausted, which producers treat as "drop the frame"."""

    def __init__(self, delegate, semaphores, sender=None):
        self._delegate = delegate
        self._semaphores = semaphores
        self._sender = sender

    def for_sender(self, sender):
        """A view of the same queue bound to a different sender."""
        return BalancedQueue(self._delegate, self._semaphores, sender)

    def put(self, obj, block=True, timeout=None):
        assert self._sender is not None
        if not self._semaphores[self._sender].acquire(block, timeout):
            raise Full
        try:
            self._delegate.put((self._sender, obj), block, timeout)
        except Exception:
            # never leak the permit: a Full delegate would otherwise
            # silence this sender forever (quota never released)
            self._semaphores[self._sender].release()
            raise

    def get(self, block=True, timeout=None):
        sender, obj = self._delegate.get(block, timeout)
        self._semaphores[sender].release()
        return obj

    def put_nowait(self, obj):
        return self.put(obj, False)

    def get_nowait(self):
        return self.get(False)

    def qsize(self):
        return self._delegate.qsize()

    def empty(self):
        return self._delegate.empty()

    def full(self):
        return self._delegate.full()


def balanced_queue_group(senders, maxsize=0, quota=1):
    """Create one shared delegate queue plus a bound BalancedQueue per
    sender. Consumers read any of the returned queues interchangeably."""
    delegate = Queue(maxsize)
    semaphores = {s: threading.BoundedSemaphore(quota) for s in senders}
    return {s: BalancedQueue(delegate, semaphores, s) for s in senders}


class Publish:
    """Subscriber registry with drop-on-busy delivery: `_publish` offers the
    payload to every subscriber queue with put_nowait; slow subscribers miss
    the frame rather than applying backpressure."""

    def __init__(self, lock=None):
        self._subscribers = Counter()
        self._subscribers_lock = lock if lock is not None else threading.RLock()

    def subscribe(self, a_queue):
        with self._subscribers_lock:
            self._subscribers[a_queue] += 1

    def unsubscribe(self, a_queue):
        with self._subscribers_lock:
            self._subscribers[a_queue] -= 1
            if self._subscribers[a_queue] <= 0:
                # <= 0: an unbalanced unsubscribe must not leave a
                # permanent negative-count phantom subscriber
                del self._subscribers[a_queue]

    @property
    def subscriber_count(self):
        with self._subscribers_lock:
            return len(self._subscribers)

    def _publish(self, payload):
        """Offer payload to every subscriber; returns how many accepted."""
        with self._subscribers_lock:
            count = 0
            for a_queue in self._subscribers.keys():
                try:
                    a_queue.put_nowait(payload)
                    count += 1
                except Full:
                    pass
            return count
