# Copy of watsor_tpu/output/snapshot.py: imports and paths adapted.
"""Snapshot keeper: retains the best-confidence frame per configured class
and serves it as a JPEG on demand.

Reference contract (upstream watsor/output/snapshot.py:13-93): a
private ring with one slot per configured class; a new detection replaces
the stored frame when its confidence is higher or the stored one is older
than 10 s; ``get(label)`` renders the stored frame through the effect chain
and JPEG-encodes it.
"""

import os
import threading
from time import time

from watsor_tpu_torch.config.coco import coco_label_index
from watsor_tpu_torch.runtime.frames import FrameBuffer
from watsor_tpu_torch.runtime.meters import FramesPerSecond
from watsor_tpu_torch.runtime.tasks import WorkPublish

SNAPSHOT_TTL_SECONDS = 10.0

# Replace the stored frame only on a MEANINGFUL confidence improvement.
# The stored best rises monotonically between TTL expiries, so an epsilon
# bounds the 6 MB frame copies to at most (1 - c0) / epsilon per TTL window
# (<=100 at the default), turning a per-frame worst case into noise while
# keeping the served snapshot within epsilon of the true best. 0 restores
# the reference's any-improvement semantics
# (upstream watsor/output/snapshot.py:64-85).
SNAPSHOT_EPSILON = float(os.environ.get('WATSOR_SNAPSHOT_EPSILON', 0.01))


class Snapshot(WorkPublish):

    def __init__(self, name, frame_queue, frame_buffer, class_names, effects,
                 stop_event=None, jpeg_encode=None):
        h, w = frame_buffer.frames[0].image.shape[:2]
        self._labels = {}
        for i, class_name in enumerate(class_names):
            self._labels[coco_label_index(class_name)] = i
        self._store = FrameBuffer(max(len(class_names), 1), w, h)
        self._scratch = FrameBuffer(1, w, h).frames[0]
        self._best = [(-1.0, 0.0)] * len(self._store)  # (confidence, stamp)
        self._store_lock = threading.Lock()
        self._effects = list(effects)
        self._jpeg_encode = jpeg_encode
        self.copies = 0                # stored-frame replacements (bench)
        self.fps = FramesPerSecond()
        super().__init__(name, frame_queue, frame_buffer, stop_event)

    def _new_frame(self, frame, payload):
        try:
            now = time()
            with self._store_lock:
                for det in frame.detections_view():
                    slot = self._labels.get(int(det['label']))
                    if slot is None:
                        continue
                    confidence, stamp = self._best[slot]
                    expired = now - stamp > SNAPSHOT_TTL_SECONDS
                    if expired or \
                            det['confidence'] > confidence + SNAPSHOT_EPSILON:
                        stored = self._store.frames[slot]
                        stored.header[...] = frame.header
                        stored.image[...] = frame.image
                        self._best[slot] = (float(det['confidence']), now)
                        self.copies += 1
            self.fps(True)
        finally:
            frame.latch.next()

    def get(self, class_name):
        """Render + JPEG-encode the stored best frame for a class; returns
        None when that class has never been sighted."""
        slot = self._labels.get(coco_label_index(class_name))
        if slot is None:
            return None
        with self._store_lock:
            confidence, _ = self._best[slot]
            if confidence < 0:
                return None
            stored = self._store.frames[slot]
            scratch = self._scratch
            scratch.header[...] = stored.header
            scratch.image[...] = stored.image
            for effect in self._effects:
                effect.apply(stored, scratch)
            image = scratch.image.copy()
        return self._encode(image)

    def _encode(self, image):
        if self._jpeg_encode is not None:
            return self._jpeg_encode(image)
        # single shared native-with-cv2-fallback path (http_stream owns it)
        from watsor_tpu_torch.output.http_stream import default_jpeg_encode
        return default_jpeg_encode(image) or None
