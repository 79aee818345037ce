"""The port's copies of the host layers against the JAX package's
originals, on the same inputs: configuration, zone masks, the tracker, the
fairness queue, the detector task's frame header, the native video
library and the test broker; and every copy names its source on its first
line. Every comparison is exact."""

import ast
import glob
import os
import re
import subprocess
import sys
import time
from queue import Empty

import cv2
import numpy as np
import pytest

from watsor_tpu.config import normalize as j_normalize
from watsor_tpu.config import parse as j_parse
from watsor_tpu.config import validate as j_validate
from watsor_tpu.detection.backend import _unpack_outputs as j_unpack
from watsor_tpu.detection.detector import ObjectDetector as JDetector
from watsor_tpu.filters import ConfidenceFilter as JConfidenceFilter
from watsor_tpu.filters.mask import ZoneMask as JZoneMask
from watsor_tpu.filters.mask import get_alpha_channel as j_alpha
from watsor_tpu.filters.track import TrackFilter as JTrackFilter
from watsor_tpu.io import native as j_native
from watsor_tpu.runtime.channel import balanced_queue_group as j_queues
from watsor_tpu.runtime.frames import DETECTION_DTYPE as J_DTYPE
from watsor_tpu.runtime.frames import MAX_ZONES
from watsor_tpu.runtime.frames import FrameBuffer as JFrameBuffer
from watsor_tpu_torch.config import normalize, parse, validate
from watsor_tpu_torch.detection.backend import _unpack_outputs
from watsor_tpu_torch.detection.detector import ObjectDetector
from watsor_tpu_torch.filters import ConfidenceFilter
from watsor_tpu_torch.filters.mask import ZoneMask, get_alpha_channel
from watsor_tpu_torch.filters.track import TrackFilter
from watsor_tpu_torch.io import native
from watsor_tpu_torch.runtime.channel import balanced_queue_group
from watsor_tpu_torch.runtime.frames import DETECTION_DTYPE, FrameBuffer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'config', 'config.yaml')
MASK = os.path.join(ROOT, 'config', 'porch_mask.png')


def test_config_yaml_loads_to_the_same_dict():
    base = os.path.dirname(CONFIG)
    want = j_normalize(j_validate(j_parse(CONFIG)), base)
    got = normalize(validate(parse(CONFIG)), base)
    assert got == want
    assert got['cameras']


def test_porch_mask_gives_the_same_zones():
    image = cv2.imread(MASK, cv2.IMREAD_UNCHANGED)
    alpha = get_alpha_channel(image)
    np.testing.assert_array_equal(alpha, j_alpha(image))
    got, want = ZoneMask(alpha, alpha.shape), JZoneMask(alpha, alpha.shape)
    assert got.num_zones == want.num_zones > 0
    np.testing.assert_array_equal(got.index_map, want.index_map)
    np.testing.assert_array_equal(got.alpha_factor, want.alpha_factor)
    rng = np.random.default_rng(0)
    h, w = alpha.shape
    yx = rng.uniform(0, 1, (64, 2)) * (h, w)
    boxes = np.concatenate([yx, yx + rng.uniform(5, 300, (64, 2))], -1)
    np.testing.assert_array_equal(got.bbox_zone_overlap(boxes),
                                  want.bbox_zone_overlap(boxes))


def _detection_frames(dtype, seed=0, n_frames=12):
    """A seeded sequence of detection records: two objects drifting slowly
    (so the tracker confirms them) and random clutter."""
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n_frames):
        n = int(rng.integers(2, 7))
        records = np.zeros(n, dtype)
        records['label'] = rng.choice([1, 3], n)
        records['confidence'] = rng.uniform(0.2, 1.0, n)
        yx = rng.uniform(0, 400, (n, 2))
        yx[:2] = [[100 + 2 * t, 120 + 3 * t], [300 - t, 500 + 2 * t]]
        records['label'][:2] = [1, 3]
        records['bbox'] = np.concatenate([yx, yx + rng.uniform(40, 60,
                                                               (n, 2))], -1)
        frames.append(records)
    return frames


def test_track_filter_gives_the_same_outputs():
    detect = [{'person': {'confidence': 30, 'area': 1}},
              {'car': {'confidence': 40, 'area': 1}}]
    port = TrackFilter([ConfidenceFilter(detect)], sensitivity=3)
    jax_pkg = JTrackFilter([JConfidenceFilter(detect)], sensitivity=3)
    confirmed = 0
    for mine, theirs in zip(_detection_frames(DETECTION_DTYPE),
                            _detection_frames(J_DTYPE)):
        got, got_suspicious = port(mine, (720, 1280, 3))
        want, want_suspicious = jax_pkg(theirs, (720, 1280, 3))
        assert got_suspicious == want_suspicious
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        confirmed += len(got)
    assert confirmed > 0, 'the tracker must confirm something'


def _drain(queues):
    order = []
    any_queue = next(iter(queues.values()))
    while True:
        try:
            order.append(any_queue.get_nowait())
        except Empty:
            return order


def _fairness_order(make_group):
    """Three cameras push in bursts against a quota of one in flight each:
    the accepted order, the refusals, and the order after draining."""
    cams = ['a', 'b', 'c']
    queues = make_group(cams, maxsize=8)
    accepted, refused = [], []
    for step, cam in enumerate('aabacbbcca'):
        try:
            queues[cam].put_nowait((cam, step))
            accepted.append((cam, step))
        except Exception as exc:
            refused.append((cam, step, type(exc).__name__))
        if step % 4 == 3:
            accepted.append(('drained', tuple(_drain(queues))))
    return accepted, refused, _drain(queues)


def test_balanced_queue_group_keeps_the_same_fairness_order():
    got = _fairness_order(balanced_queue_group)
    assert got == _fairness_order(j_queues)
    assert got[1], 'the quota must refuse some puts'


class _Backend:
    device_name = 'TEST 0'
    input_hw = (32, 32)


def _written_header(detector_class, buffer_class, unpack):
    """Scatter one packed output into a frame of each of two cameras and
    return what the frames' headers hold."""
    rng = np.random.default_rng(5)
    B, N = 2, 100
    packed = np.zeros((B, N + 1, 7), np.float32)
    yx = rng.uniform(0, 0.7, (B, N, 2))
    packed[:, :N, 0:4] = np.concatenate([yx, yx + 0.2], -1)
    packed[:, :N, 4] = np.where(rng.uniform(0, 1, (B, N)) > 0.6,
                                rng.uniform(0.1, 1, (B, N)), 0.0)
    packed[:, :N, 5] = rng.choice([1, 3], (B, N))
    packed[:, :N, 6] = rng.integers(0, 2 ** MAX_ZONES, (B, N))
    packed[:, N, 0] = (packed[:, :N, 4] > 0).sum(-1)
    boxes, scores, classes, valid, zones = unpack(packed, B, True, MAX_ZONES)
    buffers = {name: buffer_class(2, 160, 120) for name in ('a', 'b')}
    detector = detector_class('det', None, buffers, _Backend())
    frames = [buffers[name].frames[1] for name in ('a', 'b')]
    for frame in frames:
        frame.clear()
        frame.latch.next()                             # READY -> DETECT
    detector._scatter((boxes, scores, classes, valid, 4.0, zones), frames)
    return [frame.detections_view().copy() for frame in frames]


def test_object_detector_writes_the_same_frame_header():
    got = _written_header(ObjectDetector, FrameBuffer, _unpack_outputs)
    want = _written_header(JDetector, JFrameBuffer, j_unpack)
    for g, w in zip(got, want):
        assert len(g) > 0
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_library_builds_from_the_port():
    """The port builds its own libwatsor_io.so from watsor_tpu_torch/native/
    (or, where the toolchain or libav is missing, both packages report the
    same NativeUnavailable)."""
    def outcome(module):
        try:
            return module.load().wt_version().decode(), None
        except module.NativeUnavailable as exc:
            return None, str(exc)

    got = outcome(native)
    assert native._LIB_PATH == os.path.join(ROOT, 'watsor_tpu_torch',
                                            'native', 'libwatsor_io.so')
    if got[1] is None:
        assert got[0] and os.path.exists(native._LIB_PATH)
    else:
        # only then load the JAX package's library, whose build directory
        # other test files share
        assert got == outcome(j_native)


def test_a_failed_native_load_is_kept(monkeypatch, tmp_path):
    """Where the library cannot be built (the card's machine has no libav),
    the first load's NativeUnavailable is raised again without another
    build: the MJPEG viewers encode a JPEG a frame, each through load()."""
    builds = []

    def failing_build():
        builds.append(1)
        raise native.NativeUnavailable('native build failed: no libav')

    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_lib_error', None)
    monkeypatch.setattr(native, '_LIB_PATH', str(tmp_path / 'missing.so'))
    monkeypatch.setattr(native, '_build', failing_build)
    errors = []
    for _ in range(3):
        with pytest.raises(native.NativeUnavailable) as err:
            native.load()
        errors.append(err.value)
    assert len(builds) == 1
    assert errors[0] is errors[1] is errors[2]


_FIRST_LOAD = """
import sys, time
sys.path.insert(0, {root!r})
from watsor_tpu_torch.io import native
native._NATIVE_DIR = {native_dir!r}
native._LIB_PATH = {lib!r}
start = float(sys.argv[1])
while time.time() < start:
    time.sleep(0.001)
try:
    native.load()
    print('loaded')
except Exception as exc:
    print(type(exc).__name__, str(exc).splitlines()[0])
"""

# a "linker" that writes the library slowly: its first 4 KiB, a pause,
# then the rest, so that a partial file stands for 1.5 s
_SLOW_MAKEFILE = """TARGET := libwatsor_io.so
$(TARGET):
\t{python} -c "import sys, time; data = open(sys.argv[1], 'rb').read(); \\
f = open(sys.argv[2], 'wb'); f.write(data[:4096]); f.flush(); \\
time.sleep(1.5); f.write(data[4096:]); f.close()" {source} $@
"""


def test_concurrent_first_loads_each_find_a_whole_library(tmp_path):
    """Processes that find no library build it at the same time, as the
    test workers of a fresh checkout do: each finds a whole library (here
    any shared object, written slowly by a stand-in for the linker; it
    lacks the runtime's symbols, so each load ends in the same
    AttributeError), none a half-written file ("file too short"), and no
    partial build is left behind."""
    import _ctypes
    (tmp_path / 'Makefile').write_text(_SLOW_MAKEFILE.format(
        python=sys.executable, source=_ctypes.__file__))
    script = _FIRST_LOAD.format(root=ROOT, native_dir=str(tmp_path),
                                lib=str(tmp_path / 'libwatsor_io.so'))
    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, '-c', script,
                               str(start + delay)],
                              stdout=subprocess.PIPE, text=True)
             for delay in (0.0, 0.6, 0.9, 1.2)]
    outcomes = [proc.communicate(timeout=120)[0].strip() for proc in procs]
    assert len(set(outcomes)) == 1, outcomes
    assert outcomes[0].startswith('AttributeError'), outcomes
    assert not list(tmp_path.glob('*.part'))


def _copies():
    """(copy, its source) for every file of the port whose first line reads
    '# Copy of <source>'."""
    found = []
    for path in sorted(glob.glob(os.path.join(ROOT, 'watsor_tpu_torch', '**',
                                              '*'), recursive=True)):
        if not path.endswith(('.py', 'Makefile')):
            continue
        with open(path) as f:
            match = re.match(r'# Copy of (watsor_tpu/\S+?)[.:;]?(\s|$)',
                             f.readline())
        if match:
            found.append((os.path.relpath(path, ROOT), match.group(1)))
    return found


COPIES = _copies()


@pytest.mark.parametrize('copy,source', COPIES,
                         ids=[copy for copy, _ in COPIES])
def test_copies_name_their_source(copy, source):
    assert os.path.isfile(os.path.join(ROOT, source)), source
    assert copy.split(os.sep, 1)[1] == source.split('/', 1)[1], \
        'a copy keeps its source\'s place in the package'


def _code(path):
    """The module's syntax tree without its docstring, dumped."""
    with open(path) as f:
        tree = ast.parse(f.read())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


def test_broker_copy_is_the_original():
    """testing/broker.py is copied with only its docstring's path adapted:
    the port's fleet rig hosts its MQTT client on the same broker as the
    JAX package's."""
    assert ('watsor_tpu_torch/testing/broker.py',
            'watsor_tpu/testing/broker.py') in COPIES
    assert _code(os.path.join(ROOT, 'watsor_tpu_torch', 'testing',
                              'broker.py')) == \
        _code(os.path.join(ROOT, 'watsor_tpu', 'testing', 'broker.py'))
