# Copy of watsor_tpu/io/native.py: paths adapted, a failed load kept, the
# build renamed into place.
"""ctypes bindings for the native video I/O runtime (libwatsor_io.so).

Builds the shared library on first use (``make`` in watsor_tpu/native/)
and exposes thin Python wrappers. Every heavy call (decode, encode, JPEG)
runs with the GIL released — ctypes drops it around foreign calls — so the
decoder tasks genuinely overlap with the detection dispatch thread.

The native layer replaces the reference's per-camera ffmpeg subprocesses
and pipes (upstream watsor/stream/ffmpeg.py): decoded RGB24 lands
directly in the frame arena, and a detect-resolution plane is produced in
the same swscale pass.
"""

import ctypes
import logging
import os
import subprocess
import threading
from time import sleep

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), os.pardir, 'native')
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, 'libwatsor_io.so'))

_lib = None
_lib_error = None        # the NativeUnavailable of a failed load, kept
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build():
    """``make`` the library into a file of this process's own, then rename
    it over ``_LIB_PATH``: a process that finds the path finds a whole
    library, however many processes build at once (the test workers of a
    fresh checkout do; a half-written file loads as "file too short")."""
    native_dir = os.path.abspath(_NATIVE_DIR)
    partial = os.path.join(native_dir, '{}.{}.part'.format(
        os.path.basename(_LIB_PATH), os.getpid()))
    try:
        subprocess.run(['make', '-s', 'TARGET=' + os.path.basename(partial)],
                       cwd=native_dir, check=True, capture_output=True,
                       timeout=300)
        os.replace(partial, _LIB_PATH)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        detail = getattr(e, 'stderr', b'') or b''
        raise NativeUnavailable(
            'native build failed: {}'.format(detail.decode(errors='replace')))
    finally:
        if os.path.exists(partial):
            os.remove(partial)


def load():
    """Load (building if needed) the native library; raises
    NativeUnavailable when the toolchain or FFmpeg libs are missing."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            # a machine without the toolchain or libav: every JPEG of every
            # MJPEG viewer would otherwise run make again under this lock
            raise _lib_error
        try:
            if not os.path.exists(_LIB_PATH):
                _build()
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError as e:
                raise NativeUnavailable(str(e))
        except NativeUnavailable as e:
            _lib_error = e
            raise

        lib.wt_decoder_open.restype = ctypes.c_void_p
        lib.wt_decoder_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_char_p, ctypes.c_int]
        lib.wt_decoder_read.restype = ctypes.c_int
        lib.wt_decoder_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double)]
        lib.wt_decoder_close.argtypes = [ctypes.c_void_p]
        lib.wt_decoder_src_width.restype = ctypes.c_int
        lib.wt_decoder_src_width.argtypes = [ctypes.c_void_p]
        lib.wt_decoder_src_height.restype = ctypes.c_int
        lib.wt_decoder_src_height.argtypes = [ctypes.c_void_p]
        lib.wt_decoder_fps.restype = ctypes.c_double
        lib.wt_decoder_fps.argtypes = [ctypes.c_void_p]

        lib.wt_encoder_open.restype = ctypes.c_void_p
        lib.wt_encoder_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_double, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.wt_encoder_write.restype = ctypes.c_int
        lib.wt_encoder_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.wt_encoder_read_bytes.restype = ctypes.c_int
        lib.wt_encoder_read_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.wt_encoder_close.restype = ctypes.c_int
        lib.wt_encoder_close.argtypes = [ctypes.c_void_p]

        lib.wt_jpeg_encode.restype = ctypes.c_int
        lib.wt_jpeg_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        lib.wt_jpeg_ctx_open.restype = ctypes.c_void_p
        lib.wt_jpeg_ctx_open.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.wt_jpeg_ctx_encode.restype = ctypes.c_int
        lib.wt_jpeg_ctx_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.wt_jpeg_ctx_close.restype = None
        lib.wt_jpeg_ctx_close.argtypes = [ctypes.c_void_p]
        lib.wt_version.restype = ctypes.c_char_p
        lib.wt_log_install.restype = None
        lib.wt_log_next.restype = ctypes.c_int
        lib.wt_log_next.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.wt_log_install()
        _start_log_pump(lib)
        _lib = lib
        return _lib


# -- libav log routing --------------------------------------------------------
# The reference pumps every ffmpeg stderr line into the central logger
# (upstream watsor/stream/ffmpeg.py:211-224). The native runtime
# captures av_log into a ring; this pump drains it into Python logging.
# AV_LOG_ERROR and below surface at ERROR (rotating file + stderr),
# AV_LOG_WARNING at WARNING, AV_LOG_INFO at DEBUG (x264/negotiation chatter
# stays out of the log file unless explicitly enabled).

_LOG = logging.getLogger('watsor_tpu.libav')
_log_pump_thread = None

_AV_LOG_ERROR = 16
_AV_LOG_WARNING = 24


def drain_logs(lib=None):
    """Drain every buffered libav message into the logging system now.
    Returns the number of messages drained (the pump thread calls this
    periodically; tests and shutdown paths call it directly)."""
    lib = lib or _lib
    if lib is None:
        return 0
    buf = ctypes.create_string_buffer(1024)
    count = 0
    while True:
        level = lib.wt_log_next(buf, 1024)
        if level < 0:
            return count
        message = buf.value.decode(errors='replace')
        if level <= _AV_LOG_ERROR:
            _LOG.error(message)
        elif level <= _AV_LOG_WARNING:
            _LOG.warning(message)
        else:
            _LOG.debug(message)
        count += 1


def _start_log_pump(lib, interval=0.25):
    global _log_pump_thread
    if _log_pump_thread is not None:
        return

    def pump():
        while True:
            drain_logs(lib)
            sleep(interval)

    _log_pump_thread = threading.Thread(target=pump, name='libav-log-pump',
                                        daemon=True)
    _log_pump_thread.start()


def available():
    try:
        load()
        return True
    except NativeUnavailable:
        return False


class Decoder:
    """One video source: RTSP/HTTP/file -> RGB24 frames written directly
    into caller-provided numpy buffers (arena slices)."""

    def __init__(self, url, width, height, detect_hw=None, options=None,
                 realtime=False, input_format=None, hwaccel=None,
                 hwaccel_device=None, filter_fps=0.0):
        lib = load()
        errbuf = ctypes.create_string_buffer(512)
        dh, dw = detect_hw if detect_hw else (0, 0)
        self._lib = lib
        self._handle = lib.wt_decoder_open(
            url.encode(), width, height, dw, dh,
            (options or '').encode(), 1 if realtime else 0,
            (input_format or '').encode(), (hwaccel or '').encode(),
            (hwaccel_device or '').encode(), float(filter_fps or 0.0),
            errbuf, 512)
        if not self._handle:
            drain_logs(lib)  # surface libav's own account of the failure
            raise IOError('decoder open failed for {}: {}'.format(
                url, errbuf.value.decode(errors='replace')))

    @property
    def source_size(self):
        return (self._lib.wt_decoder_src_width(self._handle),
                self._lib.wt_decoder_src_height(self._handle))

    @property
    def fps(self):
        return self._lib.wt_decoder_fps(self._handle)

    def read_into(self, full_rgb: np.ndarray, detect_rgb=None):
        """Decode the next frame into the given buffers. Returns the frame
        pts in seconds, or None at EOF. Raises IOError on decode errors."""
        assert full_rgb.flags['C_CONTIGUOUS'] and full_rgb.dtype == np.uint8
        pts = ctypes.c_double()
        detect_ptr = None
        if detect_rgb is not None:
            assert detect_rgb.flags['C_CONTIGUOUS'] and \
                detect_rgb.dtype == np.uint8
            detect_ptr = detect_rgb.ctypes.data_as(ctypes.c_void_p)
        rc = self._lib.wt_decoder_read(
            self._handle, full_rgb.ctypes.data_as(ctypes.c_void_p),
            detect_ptr, ctypes.byref(pts))
        if rc == 0:
            return pts.value
        if rc == 1:
            return None
        raise IOError('decode error {}'.format(rc))

    def close(self):
        if self._handle:
            self._lib.wt_decoder_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class Encoder:
    """Record to a file (mp4/mkv by extension) or produce an in-memory
    MPEG-TS byte stream (dest='mem:', format='mpegts') for HTTP broadcast."""

    def __init__(self, dest, width, height, fps=30.0, fmt=None, codec=None,
                 bit_rate=0, options=None, input_fps=0.0, cfr=False):
        lib = load()
        errbuf = ctypes.create_string_buffer(512)
        self._lib = lib
        self._handle = lib.wt_encoder_open(
            dest.encode(), (fmt or '').encode(), (codec or '').encode(),
            width, height, fps, bit_rate, (options or '').encode(),
            float(input_fps or 0.0), 1 if cfr else 0,
            errbuf, 512)
        if not self._handle:
            drain_logs(lib)
            raise IOError('encoder open failed for {}: {}'.format(
                dest, errbuf.value.decode(errors='replace')))

    def write(self, rgb: np.ndarray):
        assert rgb.flags['C_CONTIGUOUS'] and rgb.dtype == np.uint8
        rc = self._lib.wt_encoder_write(
            self._handle, rgb.ctypes.data_as(ctypes.c_void_p))
        if rc < 0:
            raise IOError('encode error {}'.format(rc))

    def read_bytes(self, cap=65536):
        """Drain produced bytes (mem: sink). Returns b'' when nothing new."""
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.wt_encoder_read_bytes(self._handle, buf, cap)
        return buf.raw[:n] if n > 0 else b''

    def close(self):
        if self._handle:
            self._lib.wt_encoder_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def jpeg_encode(rgb: np.ndarray, quality=80) -> bytes:
    """RGB24 numpy image -> JPEG bytes via the native MJPEG encoder."""
    lib = load()
    h, w = rgb.shape[:2]
    if not rgb.flags['C_CONTIGUOUS']:
        rgb = np.ascontiguousarray(rgb)
    cap = w * h * 3 + 65536
    out = ctypes.create_string_buffer(cap)
    n = lib.wt_jpeg_encode(rgb.ctypes.data_as(ctypes.c_void_p), w, h,
                           quality, out, cap)
    if n < 0:
        raise IOError('jpeg encode error {}'.format(n))
    return out.raw[:n]


class JpegEncoder:
    """Persistent streaming JPEG encoder: codec + swscale contexts built
    once and reused per frame, with optional downscale fused into the same
    swscale pass — the MJPEG viewer hot path (the reference re-encodes at
    source resolution per frame with cv2.imencode,
    upstream watsor/output/video.py:118-149).

    Not thread-safe: callers (the per-camera JPEG cache) serialize encodes
    on one handle. The ctypes call releases the GIL, so distinct cameras'
    encoders run in parallel on multi-core hosts.
    """

    def __init__(self, src_hw, out_hw=None, quality=80):
        self._lib = load()
        self._src_hw = tuple(int(v) for v in src_hw)
        h, w = self._src_hw
        oh, ow = (h, w) if out_hw is None else \
            (int(out_hw[0]), int(out_hw[1]))
        self._handle = self._lib.wt_jpeg_ctx_open(w, h, ow, oh,
                                                  int(quality))
        if not self._handle:
            raise IOError('jpeg encoder open failed ({}x{} -> {}x{})'
                          .format(w, h, ow, oh))
        self._cap = max(w * h * 3, ow * oh * 3) + 65536
        self._out = ctypes.create_string_buffer(self._cap)

    def encode(self, rgb: np.ndarray) -> bytes:
        if rgb.shape[:2] != self._src_hw:
            raise ValueError('frame shape {} != encoder source {}'
                             .format(rgb.shape[:2], self._src_hw))
        if not rgb.flags['C_CONTIGUOUS']:
            rgb = np.ascontiguousarray(rgb)
        n = self._lib.wt_jpeg_ctx_encode(
            self._handle, rgb.ctypes.data_as(ctypes.c_void_p), self._out,
            self._cap)
        if n < 0:
            raise IOError('jpeg encode error {}'.format(n))
        # slice the char array directly (exactly n bytes) — .raw[:n]
        # would copy the whole multi-MB buffer first
        return self._out[:n]

    # encode() doubles as __call__ so the instance drops into any slot
    # expecting a plain encode function (e.g. _JpegCache)
    __call__ = encode

    def close(self):
        if self._handle:
            self._lib.wt_jpeg_ctx_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
