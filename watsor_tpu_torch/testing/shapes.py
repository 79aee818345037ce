# Copy of watsor_tpu/testing/shapes.py: imports and paths adapted.
"""Test doubles that exercise the full pipeline with zero ML dependency.

Same strategy as the reference's fixtures (upstream watsor/test/
detect_stream.py): an ``Artist`` draws random geometric shapes into shared
frames, a ``ShapeDetectorBackend`` "detects" them analytically via contour
analysis (a drop-in for the JAX backend with the same batched protocol), and
a ``ShapeCounter`` subscriber counts detections down a latch so tests finish
on completion, not on sleeps.
"""

import math
import random

import cv2
import numpy as np

from watsor_tpu_torch.detection.backend import DetectorBackend
from watsor_tpu_torch.runtime.frames import CountDownLatch, MAX_DETECTIONS
from watsor_tpu_torch.runtime.tasks import ReadDetectPublish, WorkPublish

# shape name -> 1-based label (mirrors the reference's 3-class shape model)
SHAPE_LABELS = {'triangle': 1, 'ellipse': 2, 'rectangle': 3}


class Artist(ReadDetectPublish):
    """Draws a smoothly drifting shape on a white background (the drift
    keeps the tracker's centroid matching realistic: consecutive frames
    show the same object slightly moved, switching shape occasionally)."""

    SHAPE_PERSISTENCE = 60  # frames before the shape may change

    def __init__(self, name, frame_queue, frame_buffer, stop_event=None,
                 fps=30, seed=None):
        super().__init__(name, frame_queue, frame_buffer, stop_event)
        self._period = 1.0 / fps
        self._random = random.Random(seed)
        self._state = None
        self._age = 0

    def _move(self, h, w):
        if self._state is None or self._age >= self.SHAPE_PERSISTENCE:
            size = self._random.randint(min(h, w) // 4, min(h, w) // 2)
            self._state = {
                'shape': self._random.choice(list(SHAPE_LABELS)),
                'size': size,
                'x': self._random.randint(0, w - size),
                'y': self._random.randint(0, h - size),
                'dx': self._random.choice((-2, -1, 1, 2)),
                'dy': self._random.choice((-2, -1, 1, 2)),
            }
            self._age = 0
        state = self._state
        self._age += 1
        state['x'] += state['dx']
        state['y'] += state['dy']
        if not 0 <= state['x'] <= w - state['size']:
            state['dx'] = -state['dx']
            state['x'] += 2 * state['dx']
        if not 0 <= state['y'] <= h - state['size']:
            state['dy'] = -state['dy']
            state['y'] += 2 * state['dy']
        return state

    def _new_frame(self, frame):
        self.stop_event.wait(self._period)
        if self.stop_event.is_set():
            return False
        img = frame.image
        img[:] = 255
        h, w = img.shape[:2]
        state = self._move(h, w)
        size = state['size']
        x0 = int(state['x'])
        y0 = int(state['y'])
        shape = state['shape']
        color = (0, 0, 0)
        if shape == 'triangle':
            pts = np.array([[x0 + size // 2, y0], [x0, y0 + size - 1],
                            [x0 + size - 1, y0 + size - 1]], np.int32)
            cv2.fillPoly(img, [pts], color)
        elif shape == 'ellipse':
            cv2.ellipse(img, (x0 + size // 2, y0 + size // 2),
                        (size // 2, size // 3), 0, 0, 360, color, -1)
        else:
            cv2.rectangle(img, (x0, y0), (x0 + size - 1, y0 + size - 1),
                          color, -1)
        frame.clear()
        frame.stamp()
        return True


class ShapeDetectorBackend(DetectorBackend):
    """Analytic detector: threshold + contours + vertex/area classification.

    Implements the same batched protocol as JaxDetectorBackend so it swaps
    into ObjectDetector unchanged — the reference's trick of a detector
    drop-in "with zero ML dependency" (SURVEY.md §4).
    """

    device_name = 'SHAPE ANALYTIC'

    def __init__(self, input_hw=(120, 160)):
        self.input_hw = tuple(input_hw)

    def warmup(self, hw=None, batch=1):
        pass

    def _detect_one(self, image):
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
        _, thresh = cv2.threshold(gray, 127, 255, cv2.THRESH_BINARY_INV)
        contours, _ = cv2.findContours(thresh, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        h, w = image.shape[:2]
        out = []
        for contour in contours:
            area = cv2.contourArea(contour)
            if area < 16:
                continue
            x, y, bw, bh = cv2.boundingRect(contour)
            peri = cv2.arcLength(contour, True)
            approx = cv2.approxPolyDP(contour, 0.04 * peri, True)
            fill = area / float(bw * bh)
            if len(approx) == 3:
                label = SHAPE_LABELS['triangle']
            elif len(approx) == 4 and fill > 0.9:
                label = SHAPE_LABELS['rectangle']
            else:
                label = SHAPE_LABELS['ellipse']
            out.append((label, min(0.99, fill + 0.2),
                        (y / h, x / w, (y + bh) / h, (x + bw) / w)))
        return out

    def detect_batch(self, images_u8, senders=None):
        n = images_u8.shape[0]
        boxes = np.zeros((n, MAX_DETECTIONS, 4), np.float32)
        scores = np.zeros((n, MAX_DETECTIONS), np.float32)
        classes = np.zeros((n, MAX_DETECTIONS), np.int32)
        valid = np.zeros((n,), np.int32)
        for i in range(n):
            found = self._detect_one(images_u8[i])[:MAX_DETECTIONS]
            for j, (label, conf, box) in enumerate(found):
                classes[i, j] = label
                scores[i, j] = conf
                boxes[i, j] = box
            valid[i] = len(found)
        return boxes, scores, classes, valid, 0.1


class ShapeCounter(WorkPublish):
    """Counts detected frames down a latch; tests wait on the latch instead
    of sleeping."""

    def __init__(self, name, frame_queue, frame_buffer, count,
                 stop_event=None):
        super().__init__(name, frame_queue, frame_buffer, stop_event)
        self.latch = CountDownLatch(count)
        self.seen_labels = []

    def _new_frame(self, frame, payload):
        try:
            detections = frame.detections_view()
            if len(detections):
                self.seen_labels.extend(int(d['label']) for d in detections)
                self.latch.count_down()
        finally:
            frame.latch.next()
