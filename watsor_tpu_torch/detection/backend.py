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

While a torch.profiler capture runs, each phase records a span
(runtime/spans.py): ``backend.dispatch`` (counts ``frames`` and
``bucket``) over ``backend.stage_wait``, ``backend.fill`` (``bytes``),
``backend.h2d``, ``backend.step``, ``backend.filters`` and
``backend.pack``; ``backend.resolve`` over ``backend.wait``,
``backend.fetch``, ``backend.unpack`` and ``backend.refine`` (``rows``).
"""

import contextlib
import logging
import threading
from time import perf_counter
from typing import Tuple

import numpy as np
import torch

from watsor_tpu_torch.ops.filter_device import apply_filters_device_indexed
from watsor_tpu_torch.runtime import spans
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
    result arrays in place; returns the number of rows it tested."""
    tested = 0
    for i, sender in enumerate(senders[:len(boxes)]):
        refiner = zone_refiners.get(sender)
        if refiner is None:
            continue                       # no mask: zones disabled
        rows = np.nonzero(scores[i] > 0.0)[0]
        if not len(rows):
            continue
        tested += len(rows)
        keep, hit = refiner(boxes[i, rows], classes[i, rows])
        zones_hit[i, rows] = hit[:, :zones_hit.shape[2]]
        drop = rows[~keep]
        if len(drop):
            scores[i, drop] = 0.0
            classes[i, drop] = 0
            zones_hit[i, drop] = False
            valid[i] -= len(drop)
    return tested


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


def _finish(packed, start, n, with_zones, senders, zone_refiners):
    """The detect_batch tuple from a step's packed result on the host
    (dispatched at ``start``), with the exact zone refinement."""
    device_ms = (perf_counter() - start) * 1000.0
    with spans.span('backend.unpack'):
        boxes, scores, classes, valid, zones_hit = _unpack_outputs(
            packed, n, with_zones, MAX_ZONES)
    if zones_hit is None:
        return boxes, scores, classes, valid, device_ms
    if senders is not None and zone_refiners:
        with spans.span('backend.refine') as traced:
            traced.count(rows=_refine_zones(zone_refiners, senders, boxes,
                                            scores, classes, valid,
                                            zones_hit))
    return boxes, scores, classes, valid, device_ms, zones_hit


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


class PinnedStaging:
    """Host staging for H2D copies: on the card two pinned buffers per
    padded shape, used in turn, each refilled only after every copy made
    from it has finished; on the CPU a fresh tensor a batch."""

    def __init__(self, pinned):
        self._pinned = pinned
        self._slots = {}           # shape -> two (buffer, copy events)
        self._sel = 0

    def fill(self, rows, shape):
        """``rows`` (a batch array, or a list of frames) copied into a host
        uint8 tensor of ``shape``, zero-padded past ``len(rows)``. Returns
        (tensor, copies): the caller appends the event of each copy it
        queues from the tensor."""
        n = len(rows)
        with spans.span('backend.stage_wait'):
            host, copies = self._slot(shape)
        with spans.span('backend.fill', bytes=host.numel()):
            dst = host.numpy()
            if isinstance(rows, np.ndarray):
                dst[:n] = rows
            else:
                for i, row in enumerate(rows):
                    dst[i] = row
            dst[n:] = 0
        return host, copies

    def _slot(self, shape):
        """The next host tensor of ``shape`` and its copy events, once
        every copy made from it has finished."""
        if not self._pinned:
            return torch.zeros(shape, dtype=torch.uint8), []
        slots = self._slots.setdefault(tuple(shape), [None, None])
        self._sel ^= 1
        if slots[self._sel] is None:
            slots[self._sel] = (torch.zeros(shape, dtype=torch.uint8,
                                            pin_memory=True), [])
        host, copies = slots[self._sel]
        for event in copies:
            event.synchronize()     # its previous H2D has finished
        copies.clear()
        return host, copies


def recorded(stream):
    """A CUDA event recorded on ``stream`` now."""
    event = torch.cuda.Event()
    event.record(stream)
    return event


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


def _step(detector, x, table_store, row_idx):
    """Detect on the device batch ``x``, then with ``row_idx`` the camera
    filters from ``table_store``'s tables, then pack: one packed tensor."""
    with spans.span('backend.step'):
        out = detector.detect_batch(x)
    if row_idx is None:
        with spans.span('backend.pack'):
            return pack_outputs(out.boxes, out.scores, out.classes,
                                out.valid)
    with spans.span('backend.filters'):
        scores, classes, zones_hit, valid = apply_filters_device_indexed(
            out.boxes, out.scores, out.classes, *table_store.tables,
            torch.from_numpy(row_idx).to(x.device))
    with spans.span('backend.pack'):
        return pack_outputs(out.boxes, scores, classes, valid, zones_hit)


def _fetch(shards):
    """Each (packed tensor, done event or None) of ``shards`` on the host,
    once its step has finished: a list of arrays."""
    arrays = []
    for packed, done in shards:
        with spans.span('backend.wait'):
            if done is not None:
                done.synchronize()
        with spans.span('backend.fetch'):
            arrays.append(packed.cpu().numpy())
    return arrays


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
        self._staging = PinnedStaging(self._cuda)

    def warmup(self, hw=None, batch=1):
        """Run the step once at the bucket live batches will use (on the
        card this also builds the CUDA kernels)."""
        h, w = hw if hw is not None else self.input_hw
        b = max(_bucket(batch), self._min_bucket)
        senders = None
        if self._table_store is not None:
            senders = [self._table_store.names[0]] * b
        self.detect_batch(np.zeros((b, h, w, 3), np.uint8), senders=senders)

    def dispatch(self, images_u8, senders=None):
        """Queue H2D + detect + filters + pack without waiting for the
        device; returns a handle for :meth:`resolve`. The caller must not
        mutate ``images_u8`` until this returns."""
        n = images_u8.shape[0]
        b = max(_bucket(min(n, self._max_batch)), self._min_bucket)
        with spans.span('backend.dispatch', batch=spans.NEXT, frames=n,
                        bucket=b) as traced:
            row_idx = None
            if self._table_store is not None and senders is not None:
                row_idx = self._table_store.rows(senders, b)
            with self._lock:
                start = perf_counter()
                host, copies = self._staging.fill(images_u8,
                                                  (b,) + images_u8.shape[1:])
                stream = torch.cuda.stream(self._stream) if self._cuda \
                    else contextlib.nullcontext()
                with stream, torch.inference_mode():
                    with spans.span('backend.h2d'):
                        x = host.to(self._device, non_blocking=True)
                        if self._cuda:
                            copies.append(recorded(self._stream))
                    packed = _step(self._detector, x, self._table_store,
                                   row_idx)
                    done = recorded(self._stream) if self._cuda else None
        return (packed, done, row_idx is not None, n, start, senders,
                traced.batch)

    def resolve(self, handle):
        """Wait for a dispatched step; returns the detect_batch tuple."""
        packed, done, with_zones, n, start, senders, batch = handle
        with spans.span('backend.resolve', batch=batch):
            packed, = _fetch([(packed, done)])
            return _finish(packed, start, n, with_zones, senders,
                           self._zone_refiners)

    def detect_batch(self, images_u8, senders=None):
        return self.resolve(self.dispatch(images_u8, senders=senders))


class FleetBackend(DetectorBackend):
    """Detection over a fleet (counterpart of FleetBackend in
    watsor_tpu/detection/backend.py:283-412): one step whose batch spans
    every device of the mesh. The batch pads up to a multiple of the
    data-axis size so each shard is equal; each shard runs detect, the
    device filters (with its own device's copy of the camera tables) and
    packing on its own stream, and ``resolve`` makes one D2H copy a
    shard."""

    def __init__(self, fleet, max_batch=64, camera_tables=None,
                 zone_refiners=None, min_batch=None):
        self._fleet = fleet
        self._max_batch = max_batch
        self._lock = threading.Lock()
        mesh = fleet.mesh
        self._devices = fleet.devices
        self._data_size = mesh.shape['data']
        if min_batch is None:
            min_batch = _min_bucket_env()
        self._min_bucket = min(_bucket(max(int(min_batch), 1)),
                               _bucket(max_batch))
        axes = ', '.join('{}: {}'.format(axis, size)
                         for axis, size in mesh.shape.items()
                         if axis == 'data' or size > 1)
        self.device_name = '{} MESH {{{}}}'.format(
            self._devices[0].type.upper(), axes)
        size = fleet.config.input_size
        self.input_hw = (size, size)
        self._table_stores = None
        if camera_tables:
            self._table_stores = {
                d: _FilterTableStore(camera_tables, d)
                for d in dict.fromkeys(self._devices)}
        self._zone_refiners = zone_refiners or {}
        self._cuda = any(d.type == 'cuda' for d in self._devices)
        self._staging = PinnedStaging(self._cuda)

    def _target(self, n):
        """The padded batch: the bucket of ``n``, at least the data size and
        the floor bucket, rounded up to a multiple of the data size."""
        target = max(_bucket(min(n, self._max_batch)), self._data_size,
                     self._min_bucket)
        return -(-target // self._data_size) * self._data_size

    def warmup(self, hw=None, batch=None):
        """Run the step once at the batch live traffic will use; with camera
        tables, the filtered step, which every live batch takes."""
        h, w = hw if hw is not None else self.input_hw
        n = self._target(batch or self._data_size)
        senders = None
        if self._table_stores is not None:
            senders = [next(iter(self._table_stores.values())).names[0]] * n
        self.detect_batch(np.zeros((n, h, w, 3), np.uint8), senders=senders)

    def dispatch(self, images_u8, senders=None):
        """Queue every shard's H2D + detect + filters + pack without
        waiting for the devices; returns a handle for :meth:`resolve`."""
        n = images_u8.shape[0]
        target = self._target(n)
        with spans.span('backend.dispatch', batch=spans.NEXT, frames=n,
                        bucket=target) as traced:
            row_idx = None
            if self._table_stores is not None and senders is not None:
                row_idx = next(iter(self._table_stores.values())).rows(
                    senders, target)
            with self._lock:
                start = perf_counter()
                host, copies = self._staging.fill(
                    images_u8, (target,) + images_u8.shape[1:])
                rows = self._fleet.shard_batch(row_idx) \
                    if row_idx is not None else None

                def step(i, x):
                    if rows is None:
                        return _step(self._fleet.replicas[i], x, None, None)
                    return _step(self._fleet.replicas[i], x,
                                 self._table_stores[self._devices[i]],
                                 rows[i])
                outs = self._fleet.shard_steps(host, step, copies)
        packed = [out for out, _ in outs]
        done = [event for _, event in outs]
        return (packed, done, row_idx is not None, n, start, senders,
                traced.batch)

    def resolve(self, handle):
        """Wait for every shard; one D2H copy each, concatenated in mesh
        order; returns the detect_batch tuple."""
        packed, done, with_zones, n, start, senders, batch = handle
        with spans.span('backend.resolve', batch=batch):
            arrays = _fetch(zip(packed, done))
            return _finish(np.concatenate(arrays, axis=0), start, n,
                           with_zones, senders, self._zone_refiners)

    def detect_batch(self, images_u8, senders=None):
        return self.resolve(self.dispatch(images_u8, senders=senders))
