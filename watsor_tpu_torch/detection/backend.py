"""The PyTorch detector backend (counterpart of JaxDetectorBackend in
watsor_tpu/detection/backend.py:58-260,415-564).

One step per batch, on the backend's own CUDA stream: H2D from pinned
staging, detect, per-camera device filters, and packing into one f32
``[B, N+1, 7]`` array (cols 0:4 boxes, 4 score, 5 class, 6 zone bitmask;
row N carries ``valid`` in col 0). ``dispatch`` returns as soon as the
step is queued; ``resolve`` waits on the step's event and makes the one
D2H copy. The host-side helpers (buckets, unpacking, the exact zone
refinement) and the ``DetectorBackend`` protocol are copied from
watsor_tpu/detection/backend.py:25-55,98-118,247-280.
"""

import contextlib
import logging
import threading
from time import perf_counter
from typing import Tuple

import numpy as np
import torch

from watsor_tpu_torch.ops.filter_device import apply_filters_device_indexed
from watsor_tpu_torch.runtime.frames import MAX_ZONES

_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# the zone bitmask rides in f32, exact only up to 24 bits
_MAX_ZONE_BITS = 24
assert MAX_ZONES <= _MAX_ZONE_BITS, \
    'packed zone bitmask is f32-exact only up to 24 bits'


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 31) // 32) * 32


def _min_bucket_env() -> int:
    """Parse WATSOR_MIN_BUCKET with the same warn-and-fall-back posture as
    resolve_device_pool: a malformed value ('auto', '1.5') must not crash
    detector startup."""
    import os

    raw = os.environ.get('WATSOR_MIN_BUCKET', '') or ''
    if not raw.strip():
        return 1
    try:
        return int(raw)
    except ValueError:
        logging.getLogger('watsor_tpu.detector').warning(
            'Ignoring malformed WATSOR_MIN_BUCKET=%r (want an integer); '
            'using 1', raw)
        return 1


def _refine_zones(zone_refiners, senders, boxes, scores, classes, valid,
                  zones_hit):
    """Exact full-res host zone pass over the device-filtered survivors
    (ops/filter_device.ZoneRefiner); the device test over-approximates so
    this only ever REMOVES boundary-band false keeps. Mutates the sliced
    result arrays in place."""
    for i, sender in enumerate(senders[:len(boxes)]):
        refiner = zone_refiners.get(sender)
        if refiner is None:
            continue                       # no mask: zones disabled
        rows = np.nonzero(scores[i] > 0.0)[0]
        if not len(rows):
            continue
        keep, hit = refiner(boxes[i, rows], classes[i, rows])
        zones_hit[i, rows] = hit[:, :zones_hit.shape[2]]
        drop = rows[~keep]
        if len(drop):
            scores[i, drop] = 0.0
            classes[i, drop] = 0
            zones_hit[i, drop] = False
            valid[i] -= len(drop)


def _unpack_outputs(packed, n, with_zones, max_zones):
    """Host-side split of the packed fetch back into the detect_batch
    contract arrays (sliced to the real batch n)."""
    body = packed[:n, :-1, :]
    boxes = np.ascontiguousarray(body[..., 0:4])
    scores = np.ascontiguousarray(body[..., 4])
    classes = body[..., 5].astype(np.int32)
    valid = packed[:n, -1, 0].astype(np.int32)
    if not with_zones:
        return boxes, scores, classes, valid, None
    zbits = body[..., 6].astype(np.int64)
    zones_hit = (zbits[..., None] >> np.arange(max_zones)) & 1 != 0
    return boxes, scores, classes, valid, zones_hit


class DetectorBackend:
    """Protocol: batched uint8 frames in, padded detection arrays out."""

    device_name = 'unknown'
    input_hw: Tuple[int, int] = (300, 300)

    def detect_batch(self, images_u8: np.ndarray, senders=None):
        """images_u8: [B, H, W, 3] -> (boxes [B,N,4] normalized float32,
        scores [B,N] float32, classes [B,N] int32 1-based, valid [B] int32,
        device_ms float[, zones_hit [B,N,Z] bool when the backend filters
        on device]). ``senders`` optionally names the camera of each row so
        per-camera filter tables can apply."""
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _FilterTableStore:
    """Every camera's filter tables, resident on the device as
    ``[num_cameras, ...]`` tensors; a batch ships only its row indices."""

    def __init__(self, camera_tables, device):
        names = sorted(camera_tables)
        self.names = names
        self._row = {name: i for i, name in enumerate(names)}
        self.tables = tuple(
            torch.from_numpy(np.stack([np.asarray(camera_tables[name][i])
                                       for name in names])).to(device)
            for i in range(4))

    # copied from watsor_tpu/detection/backend.py:82-87
    def rows(self, senders, b):
        """[b] int32 row indices (padding rows reuse row 0)."""
        idx = np.zeros(b, np.int32)
        for i, sender in enumerate(senders[:b]):
            idx[i] = self._row[sender]
        return idx


def pack_outputs(boxes, scores, classes, valid, zones_hit=None):
    """Detections (+ zone hits) -> one f32 [B, N+1, 7] tensor."""
    if zones_hit is None:
        zbits = torch.zeros_like(scores, dtype=torch.float32)
    else:
        if zones_hit.shape[-1] > _MAX_ZONE_BITS:
            raise ValueError('zone bitmask exceeds the f32-exact range '
                             '({} bits)'.format(_MAX_ZONE_BITS))
        weights = 2.0 ** torch.arange(zones_hit.shape[-1],
                                      dtype=torch.float32,
                                      device=zones_hit.device)
        zbits = (zones_hit.float() * weights).sum(dim=-1)
    body = torch.cat([boxes.float(), scores[..., None].float(),
                      classes[..., None].float(), zbits[..., None]], dim=-1)
    tail = torch.zeros((body.shape[0], 1, body.shape[2]),
                       dtype=torch.float32, device=body.device)
    tail[:, 0, 0] = valid.float()
    return torch.cat([body, tail], dim=1)


class TorchDetectorBackend(DetectorBackend):
    """Batched uint8 frames in, padded detections out, on one device.

    Batches pad up to the JAX backend's size buckets (and the
    WATSOR_MIN_BUCKET floor) so a deployment sees a few fixed shapes."""

    def __init__(self, detector, device=None, max_batch=64,
                 camera_tables=None, zone_refiners=None, min_batch=None):
        self._detector = detector
        self._device = torch.device(device) if device is not None \
            else detector.device
        if self._device != detector.device:
            raise ValueError('detector lives on {}, backend asked for {}'
                             .format(detector.device, self._device))
        self._max_batch = max_batch
        if min_batch is None:
            min_batch = _min_bucket_env()
        self._min_bucket = min(_bucket(max(int(min_batch), 1)),
                               _bucket(max_batch))
        self._lock = threading.Lock()
        self.device_name = '{} {}'.format(self._device.type.upper(),
                                          self._device.index or 0)
        size = detector.config.input_size
        self.input_hw = (size, size)
        self._table_store = None
        if camera_tables:
            self._table_store = _FilterTableStore(camera_tables,
                                                  self._device)
        self._zone_refiners = zone_refiners or {}
        self._cuda = self._device.type == 'cuda'
        self._stream = torch.cuda.Stream(self._device) if self._cuda \
            else None
        # two pinned staging buffers per batch shape, used in turn; each
        # remembers the event of its last H2D copy
        self._staging = {}
        self._staging_sel = 0

    def warmup(self, hw=None, batch=1):
        """Run the step once at the bucket live batches will use (on the
        card this also builds the CUDA kernels)."""
        h, w = hw if hw is not None else self.input_hw
        b = max(_bucket(batch), self._min_bucket)
        senders = None
        if self._table_store is not None:
            senders = [self._table_store.names[0]] * b
        self.detect_batch(np.zeros((b, h, w, 3), np.uint8), senders=senders)

    def _stage(self, images_u8, b):
        """Copy the batch into pinned host memory, zero-padded to ``b``."""
        n = images_u8.shape[0]
        key = (b,) + images_u8.shape[1:]
        if not self._cuda:
            batch = torch.zeros(key, dtype=torch.uint8)
            batch[:n] = torch.from_numpy(images_u8)
            return batch, None
        buffers = self._staging.setdefault(key, [None, None])
        self._staging_sel ^= 1
        slot = buffers[self._staging_sel]
        if slot is None:
            slot = buffers[self._staging_sel] = [
                torch.zeros(key, dtype=torch.uint8, pin_memory=True), None]
        host, copied = slot
        if copied is not None:
            copied.synchronize()        # its previous H2D has finished
        host[:n] = torch.from_numpy(images_u8)
        host[n:] = 0
        slot[1] = torch.cuda.Event()
        return host, slot[1]

    def dispatch(self, images_u8, senders=None):
        """Queue H2D + detect + filters + pack without waiting for the
        device; returns a handle for :meth:`resolve`. The caller must not
        mutate ``images_u8`` until this returns."""
        n = images_u8.shape[0]
        b = max(_bucket(min(n, self._max_batch)), self._min_bucket)
        row_idx = None
        if self._table_store is not None and senders is not None:
            row_idx = self._table_store.rows(senders, b)
        with self._lock:
            start = perf_counter()
            host, copied = self._stage(images_u8, b)
            stream = torch.cuda.stream(self._stream) if self._cuda \
                else contextlib.nullcontext()
            with stream, torch.inference_mode():
                x = host.to(self._device, non_blocking=True)
                if copied is not None:
                    copied.record(self._stream)
                out = self._detector.detect_batch(x)
                if row_idx is not None:
                    idx = torch.from_numpy(row_idx).to(self._device)
                    scores, classes, zones_hit, valid = \
                        apply_filters_device_indexed(
                            out.boxes, out.scores, out.classes,
                            *self._table_store.tables, idx)
                    packed = pack_outputs(out.boxes, scores, classes, valid,
                                          zones_hit)
                else:
                    packed = pack_outputs(out.boxes, out.scores, out.classes,
                                          out.valid)
                done = None
                if self._cuda:
                    done = torch.cuda.Event()
                    done.record(self._stream)
        return (packed, done, row_idx is not None, n, start, senders)

    def resolve(self, handle):
        """Wait for a dispatched step; returns the detect_batch tuple."""
        packed, done, with_zones, n, start, senders = handle
        if done is not None:
            done.synchronize()
        arr = packed.cpu().numpy()
        device_ms = (perf_counter() - start) * 1000.0
        boxes, scores, classes, valid, zones_hit = _unpack_outputs(
            arr, n, with_zones, MAX_ZONES)
        if zones_hit is not None:
            if senders is not None and self._zone_refiners:
                _refine_zones(self._zone_refiners, senders, boxes, scores,
                              classes, valid, zones_hit)
            return boxes, scores, classes, valid, device_ms, zones_hit
        return boxes, scores, classes, valid, device_ms

    def detect_batch(self, images_u8, senders=None):
        return self.resolve(self.dispatch(images_u8, senders=senders))
