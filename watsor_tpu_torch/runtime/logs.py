# Copy of watsor_tpu/runtime/logs.py: imports and paths adapted.
"""Centralized logging: console split (stdout below ERROR, stderr at/above)
plus an optional size-rotated file.

The reference needed a queue-based log fan-in because children were separate
processes (upstream watsor/stream/log.py:8-50); in the
single-controller design ordinary handlers suffice, but the console split
and 10 MB x 5 rotation contract is preserved. Subprocess stderr (e.g. an
external ffmpeg) is pumped into the same root logger by reader threads in
the media layer.
"""

import logging
import logging.handlers
import os
import sys


class _BelowErrorFilter(logging.Filter):
    def filter(self, record):
        return record.levelno < logging.ERROR


def init_logging(log_level="INFO", log_path=None, filename="watsor.log"):
    """Configure the root logger: stdout (< ERROR), stderr (>= ERROR) and an
    optional rotating file under ``log_path``. Returns the root logger."""
    root = logging.getLogger()
    root.setLevel(getattr(logging, str(log_level).upper(), logging.INFO))

    formatter = logging.Formatter(
        "%(asctime)s %(levelname)-8s %(threadName)-24s %(name)-24s %(message)s")

    out = logging.StreamHandler(sys.stdout)
    out.addFilter(_BelowErrorFilter())
    out.setFormatter(formatter)

    err = logging.StreamHandler(sys.stderr)
    err.setLevel(logging.ERROR)
    err.setFormatter(formatter)

    root.handlers = [out, err]

    if log_path:
        os.makedirs(log_path, exist_ok=True)
        file_handler = logging.handlers.RotatingFileHandler(
            os.path.join(log_path, filename),
            maxBytes=10 * 1024 * 1024, backupCount=5)
        file_handler.setFormatter(formatter)
        root.addHandler(file_handler)

    return root
