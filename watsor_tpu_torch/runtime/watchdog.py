# Copy of watsor_tpu/runtime/watchdog.py: imports and paths adapted.
"""Watchdog: periodically restarts registered tasks that died.

Same contract as the reference (upstream watsor/stream/watch.py:5-53):
every ``interval`` seconds each registered child is checked with
``is_alive()``; a dead child whose stop event is NOT set is re-initialized
and started again. Together with decoder EOF handling this yields the
automatic camera-reconnect loop.
"""

import logging
import threading


class WatchDog:
    def __init__(self, name="watchdog", interval=10):
        self._interval = interval
        self._tasks = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._logger = logging.getLogger(self.__class__.__name__)
        self._thread = threading.Thread(name=name, target=self._run, daemon=True)

    def add(self, task):
        with self._lock:
            self._tasks.append(task)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def join(self, timeout=None):
        self._stop.set()
        self._thread.join(timeout)

    def is_alive(self):
        return self._thread.is_alive()

    def _run(self):
        while not self._stop.wait(self._interval):
            self._check()

    def _check(self):
        with self._lock:
            tasks = list(self._tasks)
        for task in tasks:
            try:
                if not task.is_alive() and not task.is_shutdown():
                    self._logger.warning("Restarting %s", task.name)
                    task.initialize()
                    task.start()
            except Exception:
                self._logger.exception("Failed to restart %s", task.name)
