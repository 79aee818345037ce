"""The port's card workloads, as chip_smoke.py and
``python -m watsor_tpu_torch.profile_step`` drive them.

ssd_mobilenet_v2 at 300x300 (1917 anchors, 90 classes), random weights
from a seed, over the watched labels {person, car}, with device filters for
BATCH cameras of 1920x1080 frames, the first of them with the repository's
demo zone mask (config/porch_mask.png). Two paths:

- the main path: bf16 activations, ``nms: fused_exact``, the fused-block
  walk (WATSOR_FUSED_BLOCKS=1);
- the int8 path: WATSOR_QUANTIZE=int8_full with
  WATSOR_INT8_POINTWISE=pallas, calibrated on seeded frames, bf16 heads,
  ``nms: exact``.

And the other families of the zoo (FAMILIES), each at full width with
random weights from a seed, bf16, ``nms: fused_exact``, over all 90
classes, fed BATCH frames of 1920x1080.

The fleet (WATSOR_FLEET=1): the main path's detector behind a
FleetBackend, fed FLEET_BATCHES of detect planes at the model's 300x300
(the service's decoders write planes at the model's size), and the
device overlay (WATSOR_DEVICE_RENDER) at OVERLAY_BATCH frames of
1920x1080 with 100 box slots a frame (``overlay_inputs``).

Training (models/train.py): the zoo's ssd_mobilenet_v2 (and
efficientdet_lite0) at full width, random weights from a seed, AdamW at
make_optimizer's defaults, on TRAIN_BATCH images painted and labelled by
testing/prepare.py at the model's input size (``train_batch``), each step
timed by ``timed_train_steps``; and the sharded step over a (data, model)
mesh (``build_sharded_train``), TRAIN_BATCH images a card.
"""

import contextlib
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from watsor_tpu_torch.config.coco import coco_label_index
from watsor_tpu_torch.filters.mask import ZoneMask, get_alpha_channel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = 'ssd_mobilenet_v2'
BATCH = 8
FRAME_HW = (1080, 1920)
WATCHED = ('person', 'car')
DETECT = [{'person': {'confidence': 10, 'area': 1}},
          {'car': {'confidence': 10, 'area': 1, 'zones': [1, 2]}}]
MASK_PATH = os.path.join(ROOT, 'config', 'porch_mask.png')
# the zoo's other families, as chip_smoke.py's phase 4 runs them
FAMILIES = ('ssd_mobilenet_v1', 'ssdlite_mobilenet_v2', 'ssd_inception_v2',
            'efficientdet_lite0', 'efficientdet_lite1', 'efficientdet_lite2',
            'efficientdet_lite3', 'efficientdet_lite4')
# (H=W, C_in, E, C_out) of the 12 fused blocks of MobileNetV2 at 300x300
FUSED_SHAPES = [(75, 24, 144, 24)] + [(38, 32, 192, 32)] * 2 + \
    [(19, 64, 384, 64)] * 3 + [(19, 64, 384, 96)] + [(19, 96, 576, 96)] * 2 + \
    [(10, 160, 960, 160)] * 2 + [(10, 160, 960, 320)]
FLEET_BATCHES = (16, 32)
TRAIN_BATCH = 16
OVERLAY_BATCH = 16
OVERLAY_VALID = 30                    # valid boxes of the 100 slots a frame

# the card's peaks for a kernel's bound (one H100 SXM at 700 W: NVIDIA's
# data sheet, dense): device memory bytes/s and operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {'bf16': 989e12, 'f32': 67e12, 'tf32': 495e12,
              'int8': 1979e12}


class Bound:
    """The least time the card could take for some work: the bytes moved
    once over the memory rate against the operations over the peak rate of
    their type (each type on its own units), the larger of the two."""

    def __init__(self):
        self.bytes_ms = 0.0
        self.ops_ms = 0.0

    def add(self, nbytes, **ops):
        """One call: ``nbytes`` read or written once, ``ops`` counts by
        type (bf16, f32, int8). Calls add up."""
        self.bytes_ms += 1e3 * nbytes / HBM_BYTES_S
        self.ops_ms += max([1e3 * n / PEAK_OPS_S[kind]
                            for kind, n in ops.items()] + [0.0])
        return self

    @property
    def ms(self):
        return max(self.bytes_ms, self.ops_ms)

    def update(self, entry):
        entry['bound_ms'] = self.ms
        entry['bound_by'] = 'bytes' if self.bytes_ms >= self.ops_ms \
            else 'operations'


def card_label(device):
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (its
    first card), or the torch device for the CPU."""
    device = torch.device(device)
    if device.type != 'cuda':
        return str(device)
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return '{} (power limit not read: {})'.format(name, exc)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else '{} (power limit not read: {})'.format(
        name, smi.stderr.strip())


def watched_labels():
    return {coco_label_index(name) for name in WATCHED}


def build_main_path_detector(device, fused=True, seed=0,
                             dtype=torch.bfloat16, model_path=None):
    """The slice's detector on ``device``: the fused walk, or with
    ``fused=False`` the plain model (convolutions with BatchNorm), its
    activations in ``dtype``; the weights stored under ``model_path``, or
    without them from ``seed``."""
    from watsor_tpu_torch.models.ssd_fused import build_fused_detector
    from watsor_tpu_torch.models.zoo import build_from_zoo
    detector = build_from_zoo(MODEL, model_path, seed=seed,
                              active_labels=watched_labels(),
                              nms_mode='fused_exact', dtype=dtype,
                              device=device)
    return build_fused_detector(detector) if fused else detector


def build_family_detector(device, name, nms_mode='fused_exact',
                          dtype=torch.bfloat16, seed=0):
    """The zoo's ``name`` on ``device`` over all its classes."""
    from watsor_tpu_torch.models.zoo import build_from_zoo
    return build_from_zoo(name, None, seed=seed, nms_mode=nms_mode,
                          dtype=dtype, device=device)


def frames_1080p(device, batch=BATCH, seed=0):
    """Seeded uint8 frames [batch, 1080, 1920, 3] on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (batch,) + FRAME_HW + (3,), generator=g,
                         dtype=torch.uint8, device=device)


def calibration_frames(size=300, n=BATCH, seed=0):
    """Seeded uint8 calibration frames [n, size, size, 3]."""
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


def build_int8_path_detector(device, calib, seed=0):
    """The int8 path's detector on ``device``, calibrated on ``calib``."""
    from watsor_tpu_torch.models.ssd_int8 import build_int8_detector
    from watsor_tpu_torch.models.zoo import build_from_zoo
    detector = build_from_zoo(MODEL, None, seed=seed,
                              active_labels=watched_labels(),
                              nms_mode='exact', dtype=torch.bfloat16,
                              device=device)
    return build_int8_detector(detector, calib, pointwise='pallas')


def int8_pointwise_calls(batch=BATCH, size=300):
    """(M, K, N, int8 output, relu6) of each int8_matmul_requant call of one
    int8 forward in forward order (38 at any input size): the expands,
    block13's expand, the head and the extras' 1x1 units give int8 with
    relu6; the projects int8 without relu6, or f32 where a residual adds."""
    from watsor_tpu_torch.models.mobilenet_v2 import TAP_BLOCK, block_plan
    from watsor_tpu_torch.models.ssd import SSDConfig

    def down(h):                                  # a stride-2 'SAME' conv
        return -(-h // 2)
    h = down(size)
    channels = 32
    calls = []
    for index, expand, features, strides in block_plan():
        hidden = channels * expand
        if expand != 1:
            calls.append((batch * h * h, channels, hidden, True, True))
        if strides == 2:
            h = down(h)
        residual = index != TAP_BLOCK and strides == 1 and \
            channels == features
        calls.append((batch * h * h, hidden, features, not residual, False))
        channels = features
    calls.append((batch * h * h, channels, 1280, True, True))
    channels = 1280
    for features in SSDConfig().extra_features:
        calls.append((batch * h * h, channels, features // 2, True, True))
        h = down(h)
        channels = features
    return calls


def int8_call_work(M, K, N, quantize):
    """(bytes, int8 operations) of one int8_matmul_requant call for
    ``Bound.add``: int8 x and w read once, f32 scale and bias, the int8 or
    f32 output written once; 2MKN int8 operations."""
    return M * K + K * N + 8 * N + M * N * (1 if quantize else 4), \
        2 * M * K * N


# f32 operations of one IoU and its compare against the threshold: four
# min/max, two differences and their clamps, the product, the union's add,
# subtract and clamp, the division and the compare
IOU_OPS = 14


def fixed_point_work(B, C, M):
    """(bytes, f32 operations) of one fixed_point_suppress call for
    ``Bound.add``: f32 scores [B, C, M] and boxes [B, M, 4] read once, the
    keep bytes written once; the overlap relation of each image's union,
    M(M-1)/2 IoUs, shared by its classes."""
    return 4 * (B * C * M + 4 * B * M) + B * C * M, \
        IOU_OPS * B * M * (M - 1) // 2


def suppress_work(B, C, K):
    """(bytes, f32 operations) of one pallas_suppress call for
    ``Bound.add``: f32 boxes [B, C, K, 4] and scores [B, C, K] read once,
    the surviving scores written once; K(K-1)/2 IoUs for each class."""
    return 4 * (B * C * K * 4 + 2 * B * C * K), \
        IOU_OPS * B * C * K * (K - 1) // 2


def int_mm_operand(x, w):
    """w in a layout torch._int_mm takes with x, and its name: as it is,
    else column-major, which cuBLASLt asks for at some shapes. Call it
    outside any timed call. torch._int_mm is a yardstick of kernel 4's
    product; the port never calls it."""
    try:
        torch._int_mm(x, w)
        return w, 'row-major'
    except RuntimeError:
        wt = w.t().contiguous().t()
        torch._int_mm(x, wt)
        return wt, 'column-major'


def demo_zone_mask(frame_hw=FRAME_HW):
    """The repository's demo porch mask, scaled to the frame size."""
    import cv2
    image = cv2.imread(MASK_PATH, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise FileNotFoundError(MASK_PATH)
    alpha = cv2.resize(get_alpha_channel(image), (frame_hw[1], frame_hw[0]),
                       interpolation=cv2.INTER_NEAREST)
    return ZoneMask(alpha, frame_hw)


def camera_filters(cameras, frame_hw=FRAME_HW):
    """(tables, refiners) for TorchDetectorBackend: DETECT on every camera,
    the demo zone mask on the first."""
    from watsor_tpu_torch.ops.filter_device import (ZoneRefiner,
                                                    threshold_tables,
                                                    zone_tables)
    tables, refiners = {}, {}
    for i, camera in enumerate(cameras):
        mask = demo_zone_mask(frame_hw) if i == 0 else None
        conf, area = threshold_tables(DETECT)
        zone_sat, zone_allow = zone_tables(mask, DETECT)
        tables[camera] = (conf, area, zone_sat, zone_allow)
        if mask is not None:
            refiners[camera] = ZoneRefiner(mask, DETECT)
    return tables, refiners


def cudnn_block(x, we, be, wdw, bdw, wp, bp, residual):
    """The fused block as cuDNN runs it: three bf16 channels-last
    convolutions with the relu6 clamps (and the residual add). Timed as
    kernel 2's yardstick; the port never calls it."""
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)                   # NCHW view, channels last
    cl = torch.channels_last
    w1 = we.t()[:, :, None, None].contiguous(memory_format=cl)
    w2 = wdw.permute(2, 0, 1)[:, None].contiguous(memory_format=cl)
    w3 = wp.t()[:, :, None, None].contiguous(memory_format=cl)
    b1, b2, b3 = (b.to(torch.bfloat16) for b in (be, bdw, bp))

    def run():
        e = F.conv2d(xc, w1, b1).clamp_(0, 6)
        d = F.conv2d(e, w2, b2, padding=1, groups=w2.shape[0]).clamp_(0, 6)
        p = F.conv2d(d, w3, b3)
        return p + xc if residual else p
    return run


def detect_planes(n, size=300, seed=0):
    """``n`` seeded uint8 detect planes of ``size`` x ``size``."""
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


def overlay_inputs(batch=OVERLAY_BATCH, frame_hw=FRAME_HW, slots=100,
                   valid=OVERLAY_VALID, seed=0):
    """Frames, boxes and classes for the device overlay, as numpy: ``valid``
    seeded boxes a frame among ``slots`` (the rest class 0), overlapping,
    some running past the frame's edges."""
    rng = np.random.default_rng(seed)
    h, w = frame_hw
    frames = rng.integers(0, 256, (batch, h, w, 3), np.uint8)
    yx = rng.uniform(-0.05, 0.95, (batch, slots, 2)) * (h, w)
    hw = rng.uniform(0.02, 0.4, (batch, slots, 2)) * (h, w)
    boxes = np.concatenate([yx, yx + hw], -1).astype(np.float32)
    classes = np.zeros((batch, slots), np.int32)
    for b in range(batch):
        rows = rng.choice(slots, valid, replace=False)
        classes[b, rows] = rng.integers(1, 91, valid)
    return frames, boxes, classes


def overlay_work(batch, h, w, slots):
    """(bytes, f32 operations) of render_boxes: the frames read and written
    once; four [H, 2N] x [2N, W] products a frame (three colours and the
    count), two operations a multiply-add."""
    return 2 * batch * h * w * 3, 2 * 4 * batch * h * w * 2 * slots


def packed_shards(backend, frames, senders):
    """One step of ``backend`` (a TorchDetectorBackend or a FleetBackend) on
    ``frames`` from cameras ``senders``: its packed output, a CPU tensor a
    shard."""
    handle = backend.dispatch(frames, senders=senders)
    backend.resolve(handle)
    shards = handle[0] if isinstance(handle[0], list) else [handle[0]]
    return [p.cpu() for p in shards]


def step_wall_ms(backend, frames, senders, reps):
    """Median host wall time of ``backend.detect_batch`` (which waits for
    the step's result) over ``reps`` steps, after three untimed ones."""
    times = []
    for rep in range(reps + 3):
        start = time.perf_counter()
        backend.detect_batch(frames, senders=senders)
        if rep >= 3:
            times.append(1e3 * (time.perf_counter() - start))
    return statistics.median(times)


def fleet_against_single(fleet, single, frames, senders, counters, reps,
                         around=contextlib.nullcontext):
    """FleetBackend ``fleet`` against TorchDetectorBackend ``single``, both
    warmed at this batch. One fleet step inside ``around()``, with the
    ``launches`` of each wrapper in ``counters`` set to 0 just before and
    read just after; each shard's packed output against the single
    backend's on that shard's frames alone, bit for bit; then each
    backend's step wall time in turns single, fleet, fleet, single.
    Returns a dict: shards, shard (its batch), launches, equal (a bool a
    shard), kept (detections), fleet_wall_ms and single_wall_ms (two
    each)."""
    batch = len(frames)
    fleet.warmup(batch=batch)
    single.warmup(batch=batch)
    with around():
        for counter in counters:
            counter.launches = 0
        got = packed_shards(fleet, frames, senders)
        launches = {c.__name__: c.launches for c in counters}
    size = batch // len(got)
    equal = [torch.equal(shard, packed_shards(
        single, frames[i * size:(i + 1) * size],
        senders[i * size:(i + 1) * size])[0]) for i, shard in enumerate(got)]
    walls = {'fleet': [], 'single': []}
    for label in ('single', 'fleet', 'fleet', 'single'):
        walls[label].append(step_wall_ms(
            fleet if label == 'fleet' else single, frames, senders, reps))
    return {'shards': len(got), 'shard': size, 'launches': launches,
            'equal': equal, 'kept': sum(int(g[:, -1, 0].sum()) for g in got),
            'fleet_wall_ms': walls['fleet'],
            'single_wall_ms': walls['single']}


def train_batch(size, n=TRAIN_BATCH):
    """``n`` shape images painted at ``size`` x ``size`` with their boxes
    (up to 4 an image), as numpy arrays (testing/prepare.py)."""
    from watsor_tpu_torch.testing.prepare import generate_batch
    return generate_batch(n, (size, size))


def build_train_state(device, name=MODEL):
    """(config, TrainState, step) of the zoo's ``name`` on ``device``, at
    the zoo's dtype, weights from seed 0, make_optimizer()'s AdamW."""
    from watsor_tpu_torch.models.train import (init_train_state,
                                               make_train_step)
    from watsor_tpu_torch.models.zoo import model_config
    config = model_config(name)
    return config, init_train_state(config, device=device), \
        make_train_step(config)


def synchronize(devices=None):
    """Wait for every CUDA device of ``devices`` (the current one by
    default)."""
    for device in dict.fromkeys(devices or [None]):
        torch.cuda.synchronize(device)


def timed_train_steps(state, step, batch, n, devices=None):
    """``n`` train steps on ``batch``, each between two synchronizations
    of ``devices`` (the current device by default): [{'loss', 'wall_ms'
    (host clock), 'event_ms' (CUDA events around the step's launches on
    the current stream)}, ...]."""
    rows = []
    for _ in range(n):
        synchronize(devices)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(state, batch)
        end.record()
        synchronize(devices)
        rows.append({'loss': float(metrics['loss']),
                     'wall_ms': (time.perf_counter() - t0) * 1e3,
                     'event_ms': start.elapsed_time(end)})
    return rows


def mesh_devices(spec):
    """'DxM' -> (the devices of a D x M mesh over the visible cards, each
    card repeated in turn where the mesh has more devices than there are
    cards, and M)."""
    data, model = (int(x) for x in spec.lower().split('x'))
    cards = torch.cuda.device_count()
    return [torch.device('cuda', i % cards)
            for i in range(data * model)], model


def build_sharded_train(devices, model_parallel, name=MODEL,
                        per_card=TRAIN_BATCH):
    """(config, state, step, sharded batch, global batch) of the zoo's
    ``name`` over a mesh of ``devices`` (parallel/fleet.py
    ``make_sharded_train_step``): weights from seed 0, make_optimizer()'s
    AdamW, ``per_card`` painted images a distinct card."""
    from watsor_tpu_torch.models.zoo import model_config
    from watsor_tpu_torch.parallel import make_mesh, make_sharded_train_step
    config = model_config(name)
    mesh = make_mesh(devices=devices, model_parallel=model_parallel)
    state, step, shard_batch = make_sharded_train_step(mesh, config)
    n = per_card * len(set(devices))
    return config, state, step, shard_batch(
        train_batch(config.input_size, n=n)), n
