# Copy of watsor_tpu/filters/track.py: imports and paths adapted.
"""Temporal tracking/debouncing of detections.

Reference semantics (upstream watsor/filter/track.py:7-149): per-label
track histories matched by centroid distance (scipy cdist); a detection is
only *reported* after ``sensitivity`` consecutive sightings (debouncing
single-frame false positives); the reported detection merges its history —
the union bbox, the maximum confidence, and the union of triggered zones —
which suppresses bbox flapping. The filter also reports "suspicious
activity" (anything passing the static filters this frame) so the sieve can
lift the decoder's rate limit before the track is confirmed.

The tracker is tiny, stateful, and per-camera — it stays host-side by
design (SURVEY.md §5 "long-context": the only temporal state in the
system).
"""

import numpy as np
from scipy.spatial import distance

from watsor_tpu_torch.runtime.frames import DETECTION_DTYPE, MAX_ZONES


def _centroids(detections):
    bbox = detections['bbox']
    return np.stack([(bbox[:, 0] + bbox[:, 2]) / 2,
                     (bbox[:, 1] + bbox[:, 3]) / 2], axis=1)


class _Track:
    """Sliding history window in a PREALLOCATED structured ring.

    A deque of scalar records made ``_merge`` stack-and-promote structured
    dtypes every confirmed detection every frame — 72% of the tracker's
    per-frame cost at 5 detections (HOST_BUDGET profile). The ring keeps
    the window contiguous so merges read field VIEWS, and the last
    centroid is cached as two plain floats for the matcher.
    """

    __slots__ = ('buf', 'count', 'hits', 'cy', 'cx')

    def __init__(self, maxlen):
        self.buf = np.zeros(maxlen, DETECTION_DTYPE)
        self.count = 0
        self.hits = 0
        self.cy = 0.0
        self.cx = 0.0

    def append(self, rec):
        self.buf[self.count % len(self.buf)] = rec
        self.count += 1
        bbox = rec['bbox']
        self.cy = (float(bbox[0]) + float(bbox[2])) / 2.0
        self.cx = (float(bbox[1]) + float(bbox[3])) / 2.0

    def window(self):
        """The live records (ring order — merges are order-free unions)."""
        return self.buf[:min(self.count, len(self.buf))]

    def latest(self):
        return self.buf[(self.count - 1) % len(self.buf)]


class TrackFilter:
    """Wraps the static filter chain with temporal confirmation.

    ``__call__(detections, frame_shape) -> (kept_records, suspicious)``
    where ``kept_records`` is a DETECTION_DTYPE array of *merged* confirmed
    tracks and ``suspicious`` flags any activity that passed the static
    filters this frame.
    """

    def __init__(self, filters, history=10, sensitivity=5,
                 max_distance_frac=0.5):
        self._filters = list(filters)
        self._history = history
        self._sensitivity = sensitivity
        self._max_distance_frac = max_distance_frac
        self._tracks = {}  # label -> [Track]

    def reset(self):
        self._tracks.clear()

    def _match(self, tracks, detections):
        """Greedy nearest-centroid assignment, gated by a distance threshold
        relative to the detection's own size (large objects may move
        further between frames)."""
        assigned = {}
        if not tracks or not len(detections):
            return assigned
        track_pts = np.array([(t.cy, t.cx) for t in tracks])
        det_pts = _centroids(detections)
        dist = distance.cdist(track_pts, det_pts)
        bbox = detections['bbox']
        diag = np.hypot(bbox[:, 2] - bbox[:, 0], bbox[:, 3] - bbox[:, 1])
        limit = np.maximum(diag * self._max_distance_frac, 1.0)
        order = np.dstack(np.unravel_index(np.argsort(dist, axis=None),
                                           dist.shape))[0]
        used_tracks, used_dets = set(), set()
        for ti, di in order:
            if ti in used_tracks or di in used_dets:
                continue
            if dist[ti, di] > limit[di]:
                continue
            assigned[di] = ti
            used_tracks.add(ti)
            used_dets.add(di)
        return assigned

    def _merge(self, track):
        """Union bbox + max confidence + zone union over the history."""
        hist = track.window()
        out = track.latest().copy()
        bbox = hist['bbox']
        out['bbox'][0] = bbox[:, 0].min()
        out['bbox'][1] = bbox[:, 1].min()
        out['bbox'][2] = bbox[:, 2].max()
        out['bbox'][3] = bbox[:, 3].max()
        out['confidence'] = hist['confidence'].max()
        # vectorized zone union: valid columns are those below each
        # record's num_zones (zones are stored front-packed)
        zmask = np.arange(hist['zones'].shape[1]) < \
            hist['num_zones'][:, None]
        zones = np.unique(hist['zones'][zmask])
        zones = zones[zones != 0][:MAX_ZONES]
        out['zones'][:] = 0
        out['zones'][:len(zones)] = zones
        out['num_zones'] = len(zones)
        return out

    def __call__(self, detections, frame_shape):
        keep = np.ones(len(detections), bool)
        for f in self._filters:
            if not keep.any():
                break
            keep &= f(detections, frame_shape)
        candidates = detections[keep]
        suspicious = bool(len(candidates))

        confirmed = []
        for label in set(int(l) for l in candidates['label']) | \
                set(self._tracks.keys()):
            tracks = self._tracks.setdefault(label, [])
            dets = candidates[candidates['label'] == label]
            assigned = self._match(tracks, dets)
            matched_tracks = set(assigned.values())
            # age out tracks missed this frame (consecutive-sighting rule)
            survivors = []
            for ti, track in enumerate(tracks):
                if ti in matched_tracks:
                    survivors.append(track)
                # unmatched tracks are dropped: sightings must be consecutive
            for di in range(len(dets)):
                if di in assigned:
                    track = tracks[assigned[di]]
                else:
                    track = _Track(self._history)
                    survivors.append(track)
                track.append(dets[di])
                track.hits += 1
                if track.hits >= self._sensitivity:
                    confirmed.append(self._merge(track))
            if survivors:
                self._tracks[label] = survivors
            else:
                self._tracks.pop(label, None)

        if confirmed:
            return np.stack(confirmed), suspicious
        return np.zeros(0, DETECTION_DTYPE), suspicious
