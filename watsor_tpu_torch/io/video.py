# Copy of watsor_tpu/io/video.py: imports and paths adapted.
"""Video pipeline stages: camera decoder, recorder/broadcast encoder and the
MPEG-TS chunk ring.

The reference drives one ffmpeg subprocess per camera and pumps raw RGB24
through pipes (upstream watsor/stream/ffmpeg.py:19-208, argv built by
config normalization). Here decoding runs in-process through the native
runtime (watsor_tpu/native/video_io.cpp): ``_new_frame`` hands the arena
slot's memory straight to libswscale, and a detect-resolution plane is
produced in the same pass. The ffmpeg argv from the YAML config is still
accepted — recognized flags are translated to native options so existing
watsor configs work unchanged.

Lifecycle parity: EOF ends the spin gracefully (the watchdog then restarts
the decoder — automatic reconnect); MQTT 'OFF' sets the decoder's stop
event, 'ON' clears it and the watchdog resurrects it
(upstream watsor/stream/ffmpeg.py:70-76, watch.py:32-53).
"""

import logging
import os
from time import time

import numpy as np

from watsor_tpu_torch.io import native
from watsor_tpu_torch.runtime.frames import FrameBuffer
from watsor_tpu_torch.runtime.meters import FramesPerSecond, LatencyMeter, \
    RateLimiter
from watsor_tpu_torch.runtime.tasks import Payload, ReadDetectPublish, WorkPublish
from watsor_tpu_torch.runtime.channel import Publish

# ffmpeg argv flags translated into native AVOptions (applied to both the
# demuxer and the decoder context — libav consumes what each layer knows);
# pipe plumbing and rawvideo flags are owned by the framework now.
_ARGV_OPTION_FLAGS = {
    '-rtsp_transport': 'rtsp_transport',
    '-rtsp_flags': 'rtsp_flags',
    '-timeout': 'timeout',
    '-stimeout': 'stimeout',
    '-user_agent': 'user_agent',
    '-analyzeduration': 'analyzeduration',
    '-probesize': 'probesize',
    '-fflags': 'fflags',
    '-flags': 'flags',
    '-max_delay': 'max_delay',
    '-buffer_size': 'buffer_size',
    '-reorder_queue_size': 'reorder_queue_size',
    '-use_wallclock_as_timestamps': 'use_wallclock_as_timestamps',
    '-r': 'framerate',
    '-framerate': 'framerate',
    '-video_size': 'video_size',
    '-input_format': 'input_format',
}

# flags that are cosmetic or implied by the in-process design: accepted
# silently, with or without their value
_ARGV_NOOP_FLAGS = frozenset((
    '-hide_banner', '-nostdin', '-nostats', '-y', '-an', '-sn', '-dn',
))
# -hwaccel_output_format: the native pipeline always converts to RGB24 via
# swscale after (optional) hw download, so the intermediate format is moot
_ARGV_NOOP_VALUE_FLAGS = frozenset(('-loglevel', '-threads',
                                    '-hwaccel_output_format'))

# output-side plumbing the schema requires and the framework owns
# (upstream watsor/config/schema.py:161): skipped with their value
_ARGV_PLUMBING_VALUE_FLAGS = frozenset(('-f', '-pix_fmt', '-s', '-vcodec',
                                        '-c:v', '-codec:v'))


def _is_option_value(token):
    """True when the next argv token is an option VALUE: anything not
    '-'-prefixed, plus negative numbers ('-timeout -1' is valid ffmpeg);
    a bare '-' is the pipe placeholder, never a value."""
    if token == '-':
        return False
    if not token.startswith('-'):
        return True
    return len(token) > 1 and (token[1].isdigit() or token[1] == '.')


def _parse_rate(text):
    """ffmpeg rate syntax: '10', '29.97' or the fraction '30000/1001'."""
    text = str(text).strip()
    try:
        if '/' in text:
            num, den = text.split('/', 1)
            return float(num) / float(den)
        return float(text)
    except (ValueError, ZeroDivisionError):
        return None


def _parse_filtergraph(chain):
    """Split an ffmpeg ``-vf`` chain into honored intents.

    Returns ``(fps, drawtext, unknown)``: ``fps=fps=N``/``fps=N`` maps onto
    native pts-spaced frame dropping; ``scale=W:H`` is satisfied by design
    (the native decoder always swscales to the configured frame size, the
    same final geometry ffmpeg's scale + injected ``-s WxH`` produces);
    ``drawtext=...`` is honored by the host timestamp overlay. Anything
    else is reported back for the warning."""
    fps = None
    drawtext = None
    unknown = []
    depth = 0
    quote = None
    parts = []
    current = []
    i = 0
    while i < len(chain):  # commas inside quotes/parens don't split
        ch = chain[i]
        if ch == '\\' and i + 1 < len(chain):
            current.append(ch)
            current.append(chain[i + 1])
            i += 2
            continue
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in '\'"':
            quote = ch
        elif ch in '([{':
            depth += 1
        elif ch in ')]}':
            depth -= 1
        if ch == ',' and depth == 0 and quote is None:
            parts.append(''.join(current))
            current = []
        else:
            current.append(ch)
        i += 1
    parts.append(''.join(current))
    for part in parts:
        part = part.strip()
        if not part:
            continue
        name, _, args = part.partition('=')
        name = name.strip().strip("'\"")
        if name == 'fps':
            value = args.partition('=')[2] if args.startswith('fps=') \
                else args
            fps = _parse_rate(value.split(':')[0])
            if fps is None:
                unknown.append(part)
        elif name == 'scale':
            pass
        elif name == 'drawtext':
            drawtext = args
        else:
            unknown.append(name)
    return fps, drawtext, unknown


class DecoderArgs:
    """Decoded form of a watsor-style ffmpeg decoder argv."""

    def __init__(self, options, realtime, input_format, unknown,
                 hwaccel=None, hwaccel_device=None, filter_fps=None):
        self.options = options            # 'key=value,...' AVOptions
        self.realtime = realtime          # ffmpeg -re
        self.input_format = input_format  # ffmpeg -f before -i (v4l2, ...)
        self.unknown = unknown            # untranslated flags, for warnings
        self.hwaccel = hwaccel            # ffmpeg -hwaccel method
        self.hwaccel_device = hwaccel_device
        self.filter_fps = filter_fps      # -vf fps=N frame-drop rate


def decoder_args_from_argv(argv):
    """Translate a watsor-style ffmpeg decoder argv
    (upstream watsor/config/loader.py:215-237 builds these:
    ``['ffmpeg', <input flags>, '-i', url, <rawvideo plumbing>, '-']``).

    Flags before ``-i`` configure the input (translated to AVOptions /
    input format / hw device); ``-vf``/``-filter:v`` chains translate to
    native frame dropping (fps) and scaling (scale). Everything after the
    pipe plumbing is the rawvideo contract the framework owns.
    Untranslated flags are collected in ``unknown`` so the caller can warn
    instead of silently dropping user intent."""
    options = []
    realtime = False
    input_format = None
    unknown = []
    hwaccel = None
    hwaccel_device = None
    filter_fps = None
    try:
        input_end = argv.index('-i')
    except ValueError:
        input_end = len(argv)
    i = 0
    while i < len(argv):
        arg = argv[i]
        before_input = i < input_end
        has_value = i + 1 < len(argv) and _is_option_value(argv[i + 1])
        if arg == 'ffmpeg' or arg == '-' or not arg.startswith('-'):
            pass                     # program name, pipes, option values
        elif arg == '-re':
            realtime = True
        elif arg == '-i':
            i += 1                   # the input URL follows
        elif arg == '-f' and before_input and has_value:
            input_format = argv[i + 1]
            i += 1
        elif arg == '-hwaccel' and has_value:
            hwaccel = argv[i + 1]
            i += 1
        elif arg == '-hwaccel_device' and has_value:
            hwaccel_device = argv[i + 1]
            i += 1
        elif arg in ('-vf', '-filter:v') and has_value:
            fps, _, bad = _parse_filtergraph(argv[i + 1])
            if fps is not None:
                filter_fps = fps
            unknown.extend('{} {}'.format(arg, f) for f in bad)
            i += 1
        elif arg in _ARGV_OPTION_FLAGS and before_input and has_value:
            options.append('{}={}'.format(_ARGV_OPTION_FLAGS[arg],
                                          argv[i + 1]))
            i += 1
        elif arg in _ARGV_NOOP_FLAGS:
            pass
        elif arg in _ARGV_NOOP_VALUE_FLAGS:
            i += 1 if has_value else 0
        elif not before_input and arg in _ARGV_PLUMBING_VALUE_FLAGS:
            i += 1 if has_value else 0
        else:
            unknown.append(arg)
            i += 1 if has_value else 0
        i += 1
    return DecoderArgs(','.join(options), realtime, input_format, unknown,
                       hwaccel=hwaccel, hwaccel_device=hwaccel_device,
                       filter_fps=filter_fps)


def decoder_options_from_argv(argv):
    """Back-compat shim: (options_string, realtime)."""
    args = decoder_args_from_argv(argv)
    return args.options, args.realtime


# encoder argv flags translated onto the native encoder: codec selection,
# rate control and x264 tuning (the reference passes the user's argv to
# ffmpeg verbatim, upstream watsor/stream/ffmpeg.py:135-146)
_ENCODER_VALUE_FLAGS = {
    '-preset': 'preset',
    '-tune': 'tune',
    '-profile:v': 'profile',
    '-profile': 'profile',
    '-crf': 'crf',
    '-g': 'g',
    '-bf': 'bf',
    '-maxrate': 'maxrate',
    '-bufsize': 'bufsize',
    '-level': 'level',
    '-x264-params': 'x264-params',
    '-x264opts': 'x264opts',
}


def _parse_bitrate(text):
    """ffmpeg-style '2M'/'2000k'/'2000000' -> bits per second."""
    text = str(text).strip()
    scale = 1
    if text[-1:].lower() == 'k':
        scale, text = 1000, text[:-1]
    elif text[-1:].lower() == 'm':
        scale, text = 1000000, text[:-1]
    try:
        return int(float(text) * scale)
    except ValueError:
        return 0


class EncoderArgs:
    """Decoded form of a watsor-style ffmpeg encoder argv."""

    def __init__(self, codec, bit_rate, fps, options, unknown,
                 input_fps=None, cfr=False, format=None, drawtext=None):
        self.codec = codec          # libav encoder name ('libx264', ...)
        self.bit_rate = bit_rate    # bits/s, 0 = native default
        self.fps = fps              # -r on the OUTPUT side, None = source
        self.options = options      # 'key=value,...' codec AVOptions
        self.unknown = unknown
        self.input_fps = input_fps  # -r before -i (+ -vsync drop): pace in
        self.cfr = cfr              # -vsync cfr: constant output rate
        self.format = format        # -f muxer override (mpegts, mp4, ...)
        self.drawtext = drawtext    # -vf drawtext=... spec (host overlay)


def encoder_args_from_argv(argv):
    """Translate a normalized encoder argv
    (``['ffmpeg', <rawvideo in>, '-s', 'WxH', '-i', '-', <output flags>,
    target]``). Flags before ``-i`` describe the rawvideo pipe the
    framework owns, except ``-r``/``-vsync drop`` which declare input
    pacing (the README "fluent video" trick,
    upstream watsor/README.md:215-243); flags after it are the user's
    encoder tuning and are honored (codec, bitrate, fps + cfr duplication,
    muxer, preset/profile/tune/crf/gop, drawtext overlay). ``-hwaccel*``
    flags are accepted as no-ops: in the reference command they would only
    affect decoding of the rawvideo pipe input, which is a no-op there too."""
    codec = None
    bit_rate = 0
    fps = None
    options = []
    unknown = []
    input_fps = None
    input_vsync = None
    output_vsync = None
    fmt = None
    drawtext = None
    try:
        input_end = argv.index('-i')
        start = input_end + 2        # skip '-i' and the pipe token
    except ValueError:
        input_end = 0
        start = 0
    # input side: only pacing flags matter; the rawvideo contract is ours
    i = 0
    while i < input_end:
        arg = argv[i]
        has_value = i + 1 < len(argv) and _is_option_value(argv[i + 1])
        if arg == '-r' and has_value:
            input_fps = _parse_rate(argv[i + 1])
            i += 1
        elif arg == '-vsync' and has_value:
            input_vsync = argv[i + 1]
            i += 1
        i += 1
    i = start
    while i < len(argv):
        arg = argv[i]
        has_value = i + 1 < len(argv) and _is_option_value(argv[i + 1])
        if not arg.startswith('-') or arg == '-':
            pass                     # output target / option values
        elif arg in ('-vcodec', '-c:v', '-codec:v') and has_value:
            codec = argv[i + 1]
            i += 1
        elif arg in ('-b:v', '-b') and has_value:
            bit_rate = _parse_bitrate(argv[i + 1])
            i += 1
        elif arg == '-r' and has_value:
            fps = _parse_rate(argv[i + 1])
            i += 1
        elif arg == '-vsync' and has_value:
            output_vsync = argv[i + 1]
            i += 1
        elif arg in ('-vf', '-filter:v') and has_value:
            ffps, text, bad = _parse_filtergraph(argv[i + 1])
            if ffps is not None and fps is None:
                fps = ffps
            if text is not None:
                drawtext = text
            unknown.extend('{} {}'.format(arg, f) for f in bad)
            i += 1
        elif arg in _ENCODER_VALUE_FLAGS and has_value:
            options.append('{}={}'.format(_ENCODER_VALUE_FLAGS[arg],
                                          argv[i + 1]))
            i += 1
        elif arg == '-f' and has_value:
            fmt = argv[i + 1]        # muxer override; else by destination
            i += 1
        elif arg == '-pix_fmt' and has_value:
            i += 1                   # yuv420p fixed
        elif arg in ('-hwaccel', '-hwaccel_device') and has_value:
            i += 1                   # decode-side flags: no-op on rawvideo
        elif arg in _ARGV_NOOP_FLAGS:
            pass
        elif arg in _ARGV_NOOP_VALUE_FLAGS:
            i += 1 if has_value else 0
        else:
            unknown.append(arg)
            i += 1 if has_value else 0
        i += 1
    # ffmpeg maps codec aliases; honor the common ones
    if codec in ('h264', 'x264'):
        codec = 'libx264'
    cfr = output_vsync in ('cfr', '1')
    if input_vsync not in (None, 'drop', 'passthrough', '0', '2'):
        unknown.append('-vsync ' + input_vsync)
    if input_vsync not in ('drop', '2'):
        # a bare input-side -r just declares the rawvideo pipe's rate;
        # ffmpeg only drops when -vsync drop is given
        input_fps = None
    return EncoderArgs(codec, bit_rate, fps, ','.join(options), unknown,
                       input_fps=input_fps, cfr=cfr, format=fmt,
                       drawtext=drawtext)


class DrawTextOverlay:
    """Host-side rendering of the common ffmpeg ``drawtext`` use: a
    timestamp burned into recorded/broadcast video (the reference demo
    config's encoder filter, upstream watsor/config/config.yaml:62-63).

    Supports the fields that matter for that use: ``text`` with
    ``%{localtime}``/``%{localtime\\:FMT}`` expansion, ``x``/``y``
    position expressions over ``w h tw th lh``, ``fontcolor``, ``box`` +
    ``boxcolor`` (with ``@alpha``). Anything else in the spec is ignored
    rather than refused — the overlay still renders."""

    _COLORS = {'white': (255, 255, 255), 'black': (0, 0, 0),
               'red': (255, 0, 0), 'green': (0, 255, 0),
               'blue': (0, 0, 255), 'yellow': (255, 255, 0),
               'gray': (128, 128, 128), 'orange': (255, 165, 0)}

    def __init__(self, spec):
        self.fields = self._parse(spec or '')
        text = self.fields.get('text', '%{localtime}')
        self._template, self._timefmt = self._split_text(text)
        self._fontcolor = self._color(self.fields.get('fontcolor', 'white'))[0]
        self._box = self.fields.get('box', '0') not in ('0', '', 'false')
        self._boxcolor, self._boxalpha = self._color(
            self.fields.get('boxcolor', 'black@0.5'))
        # position expressions parse once here, evaluate per frame
        self._x_expr = self._compile_expr(self.fields.get('x', '8'))
        self._y_expr = self._compile_expr(self.fields.get('y', 'h-2*lh'))

    @staticmethod
    def _parse(spec):
        spec = spec.strip().strip("'\"")
        fields = {}
        part = []
        parts = []
        i = 0
        while i < len(spec):  # ':' splits fields, '\:' is literal
            ch = spec[i]
            if ch == '\\' and i + 1 < len(spec):
                part.append(spec[i + 1])
                i += 2
                continue
            if ch == ':':
                parts.append(''.join(part))
                part = []
            else:
                part.append(ch)
            i += 1
        parts.append(''.join(part))
        for item in parts:
            key, eq, value = item.partition('=')
            if eq:
                fields[key.strip().strip("'\"")] = value.strip().strip("'\"")
        return fields

    @staticmethod
    def _split_text(text):
        """'%{localtime:%c}' -> (prefix with %s slot, strftime format).
        Literal '%' outside the localtime slot is escaped so the later
        ``template % value`` expansion can't raise on user text."""
        start = text.find('%{localtime')
        if start < 0:
            return text, None
        end = text.find('}', start)
        inner = text[start + len('%{localtime'):end if end > 0 else None]
        timefmt = inner[1:] if inner.startswith(':') else '%c'
        tail = text[end + 1:] if end > 0 else ''
        head = text[:start].replace('%', '%%')
        tail = tail.replace('%', '%%')
        return head + '%s' + tail, timefmt or '%c'

    @classmethod
    def _color(cls, value):
        name, _, alpha = value.partition('@')
        rgb = cls._COLORS.get(name.strip().lower(), (255, 255, 255))
        try:
            a = float(alpha) if alpha else 1.0
        except ValueError:
            a = 1.0
        return rgb, a

    @staticmethod
    def _compile_expr(expr):
        """Parse a drawtext position expression ONCE into a closure over
        a whitelisted AST: numbers, the drawtext variables, + - * / % and
        parentheses — never Python eval (configs are untrusted operator
        input; ffmpeg's own expression parser cannot execute host code
        and neither may its emulation). Returns None for anything else."""
        import ast
        import operator
        ops = {ast.Add: operator.add, ast.Sub: operator.sub,
               ast.Mult: operator.mul, ast.Div: operator.truediv,
               ast.Mod: operator.mod, ast.USub: operator.neg,
               ast.UAdd: operator.pos}
        allowed = {'w', 'h', 'tw', 'th', 'lh', 'text_w', 'text_h',
                   'line_h', 'main_w', 'main_h'}

        def build(node):
            if isinstance(node, ast.Expression):
                return build(node.body)
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, (int, float)):
                value = node.value
                return lambda names: value
            if isinstance(node, ast.Name) and node.id in allowed:
                key = node.id
                return lambda names: names[key]
            if isinstance(node, ast.BinOp) and type(node.op) in ops:
                op = ops[type(node.op)]
                left = build(node.left)
                right = build(node.right)
                return lambda names: op(left(names), right(names))
            if isinstance(node, ast.UnaryOp) and type(node.op) in ops:
                op = ops[type(node.op)]
                operand = build(node.operand)
                return lambda names: op(operand(names))
            raise ValueError('unsupported drawtext expression')
        try:
            return build(ast.parse(expr, mode='eval'))
        except (ValueError, SyntaxError):
            return None

    def _position(self, w, h, tw, th):
        lh = th + 4
        names = {'w': w, 'h': h, 'tw': tw, 'th': th, 'lh': lh,
                 'text_w': tw, 'text_h': th, 'line_h': lh,
                 'main_w': w, 'main_h': h}

        def ev(fn, default):
            if fn is None:
                return default
            try:
                return int(fn(names))
            except Exception:
                return default
        x = ev(self._x_expr, 8)
        y = ev(self._y_expr, h - 2 * lh)
        return max(0, min(x, w - tw)), max(th, min(y + th, h - 2))

    def apply(self, image):
        import cv2
        from time import localtime, strftime
        text = self._template
        if self._timefmt:
            text = text % strftime(self._timefmt, localtime())
        h, w = image.shape[:2]
        scale = max(0.4, h / 1080.0 * 0.8)
        (tw, th), baseline = cv2.getTextSize(
            text, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)
        x, y = self._position(w, h, tw, th)
        if self._box:
            x0, y0 = max(0, x - 3), max(0, y - th - 3)
            x1, y1 = min(w, x + tw + 3), min(h, y + baseline + 3)
            patch = image[y0:y1, x0:x1].astype(np.float32)
            color = np.asarray(self._boxcolor, np.float32)
            blended = patch * (1.0 - self._boxalpha) + color * self._boxalpha
            image[y0:y1, x0:x1] = blended.astype(np.uint8)
        cv2.putText(image, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                    self._fontcolor, 1, cv2.LINE_AA)


class VideoDecoder(ReadDetectPublish):
    """Camera head: decodes into the ring's arena slots and launches the
    detect+publish protocol per frame."""

    def __init__(self, name, frame_queue, frame_buffer: FrameBuffer, url,
                 stop_event=None, options='', realtime=None,
                 rate_limiter=None, input_format=None, hwaccel=None,
                 hwaccel_device=None, filter_fps=None):
        self._url = url
        self._options = options
        self._input_format = input_format
        self._hwaccel = hwaccel
        self._hwaccel_device = hwaccel_device
        self._filter_fps = filter_fps
        # files default to paced playback (the CLI analog is `-re`)
        if realtime is None:
            realtime = os.path.exists(url)
        self._realtime = realtime
        self._decoder = None
        self.rate_limiter = rate_limiter if rate_limiter is not None \
            else RateLimiter()
        self.fps = FramesPerSecond()
        super().__init__(name, frame_queue, frame_buffer, stop_event)

    def initialize(self):
        super().initialize()
        self._close_decoder()

    def _open_decoder(self):
        frame = self.frame_buffer.frames[0]
        h, w = frame.image.shape[:2]
        detect_hw = None
        if frame.detect_plane is not None:
            detect_hw = frame.detect_plane.shape[:2]
        self._decoder = native.Decoder(self._url, w, h, detect_hw=detect_hw,
                                       options=self._options,
                                       realtime=self._realtime,
                                       input_format=self._input_format,
                                       hwaccel=self._hwaccel,
                                       hwaccel_device=self._hwaccel_device,
                                       filter_fps=self._filter_fps or 0.0)

    def _close_decoder(self):
        if self._decoder is not None:
            try:
                self._decoder.close()
            except Exception:
                pass
            self._decoder = None

    def _on_start(self):
        self._open_decoder()

    def _on_stop(self):
        self._close_decoder()

    def _new_frame(self, frame):
        if self._decoder is None:
            return False
        try:
            pts = self._decoder.read_into(frame.image, frame.detect_plane)
        except IOError:
            self._logger.exception('Decode error on %s', self.name)
            self.stop_event.set()
            return False
        if pts is None:
            # EOF: stream ended or camera dropped; end the spin so the
            # watchdog reconnects us (unless we were turned off)
            self._logger.info('Stream %s ended', self.name)
            self._end_spin()
            return False
        if not self.rate_limiter.allow():
            return False
        frame.clear()
        frame.stamp()
        self.fps(True)
        return True


class _FFmpegProcess:
    """A real ffmpeg subprocess run with the operator's VERBATIM argv,
    rawvideo rgb24 piped into arena slots — the reference's own decode
    mechanism (upstream watsor/stream/ffmpeg.py:19-110, argv
    assembled by config/loader.py:215-237). Same read_into/close interface
    as native.Decoder so FallbackVideoDecoder is a drop-in head."""

    def __init__(self, argv, width, height, binary=None):
        import collections
        import subprocess
        import threading

        self._nbytes = width * height * 3
        cmd = list(argv)
        binary = binary or os.environ.get('WATSOR_FFMPEG_BIN', 'ffmpeg')
        if cmd and cmd[0] == 'ffmpeg':
            cmd[0] = binary
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            stdin=subprocess.DEVNULL, bufsize=0)
        self._stderr_tail = collections.deque(maxlen=20)
        self._pts = 0
        thread = threading.Thread(target=self._drain_stderr, daemon=True,
                                   name='ffmpeg-stderr')
        thread.start()

    def _drain_stderr(self):
        log = logging.getLogger('watsor_tpu.ffmpeg')
        try:
            for line in iter(self._proc.stderr.readline, b''):
                text = line.decode('utf-8', 'replace').rstrip()
                if text:
                    self._stderr_tail.append(text)
                    log.debug('%s', text)
        except ValueError:
            pass                      # stderr closed during shutdown

    def read_into(self, image, detect_plane=None):
        """Fill one full-res frame (and the detect-resolution plane) from
        the pipe. Returns a frame counter, or None on clean EOF; raises
        IOError on a truncated frame / ffmpeg failure."""
        if image.flags['C_CONTIGUOUS']:
            buf = memoryview(image).cast('B')
            scratch = None
        else:                         # arena slots are contiguous; belt
            scratch = bytearray(self._nbytes)
            buf = memoryview(scratch)
        got = 0
        while got < self._nbytes:
            n = self._proc.stdout.readinto(buf[got:])
            if not n:
                break
            got += n
        if got == 0:
            rc = self._proc.wait()
            if rc != 0:
                raise IOError(
                    'ffmpeg exited with status {}: {}'.format(
                        rc, ' | '.join(self._stderr_tail) or '(no stderr)'))
            return None               # clean EOF
        if got < self._nbytes:
            raise IOError(
                'ffmpeg stream truncated mid-frame ({}/{} bytes): {}'
                .format(got, self._nbytes,
                        ' | '.join(self._stderr_tail) or '(no stderr)'))
        if scratch is not None:
            image[...] = np.frombuffer(scratch, np.uint8).reshape(
                image.shape)
        if detect_plane is not None:
            import cv2
            resized = cv2.resize(
                image, (detect_plane.shape[1], detect_plane.shape[0]),
                interpolation=cv2.INTER_LINEAR)
            np.copyto(detect_plane, resized)
        self._pts += 1
        return self._pts

    def kill(self):
        """Hard-stop from ANOTHER thread: kill the subprocess so a reader
        blocked in ``read_into`` gets EOF and returns. Safe to call
        concurrently with reads (no pipe close here — that races the
        reader; process exit closes the write end, which is enough)."""
        if self._proc.poll() is None:
            self._proc.kill()

    def close(self):
        proc = self._proc
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except Exception:
                proc.kill()
                proc.wait()
        for pipe in (proc.stdout, proc.stderr):
            try:
                pipe.close()
            except Exception:
                pass


class FallbackVideoDecoder(VideoDecoder):
    """Compat escape hatch (WATSOR_FFMPEG_FALLBACK=1): when the native
    argv translation reports unknown flags, run the user's decoder argv
    through a REAL ffmpeg binary verbatim — any option, device or filter
    ffmpeg supports then behaves exactly as it does in the reference
    (upstream watsor/stream/ffmpeg.py:41-42). Costs a subprocess +
    a raw-RGB pipe per camera; the in-process native decoder remains the
    default."""

    def __init__(self, name, frame_queue, frame_buffer, url, argv,
                 stop_event=None, rate_limiter=None):
        self._argv = list(argv)
        super().__init__(name, frame_queue, frame_buffer, url,
                         stop_event=stop_event, rate_limiter=rate_limiter,
                         realtime=False)

    def _open_decoder(self):
        frame = self.frame_buffer.frames[0]
        h, w = frame.image.shape[:2]
        self._decoder = _FFmpegProcess(self._argv, w, h)

    def terminate(self):
        # the spin thread may be BLOCKED in a pipe read (a TCP-stalled
        # source produces no bytes and no EOF); killing the subprocess
        # closes its stdout so readinto() returns and the spin observes
        # stop_event — without this, shutdown join() would hang and the
        # ffmpeg child would outlive the application
        super().terminate()
        decoder = self._decoder
        if decoder is not None:
            try:
                decoder.kill()
            except Exception:
                pass


class MpegTSRing:
    """Ring of MPEG-TS byte chunks with the same READY/PUBLISH fan-out
    protocol as video frames (the reference stores TS sections in a second
    FrameBuffer, upstream watsor/stream/ffmpeg.py:227-261 +
    main.py:331). Chunk payload lives in the slot's image plane; the valid
    byte count rides in the ``lengths`` sidecar, indexed per slot."""

    CHUNK = 188 * 64  # whole TS sections per chunk

    def __init__(self, size=64):
        self.buffer = FrameBuffer(size, self.CHUNK, 1, 1)
        self.lengths = [0] * size


class VideoEncoder(WorkPublish, Publish):
    """Consumes rendered frames and encodes them: to a file (recording,
    camera `output:` key) and/or to an in-memory MPEG-TS stream fanned out
    to HTTP subscribers through an MpegTSRing."""

    def __init__(self, name, frame_queue, frame_buffer, width, height,
                 fps=30.0, output_path=None, broadcast=False,
                 stop_event=None, codec=None, bit_rate=0, options=None,
                 input_fps=None, cfr=False, fmt=None, drawtext=None):
        self._width = width
        self._height = height
        self._fps_target = fps if fps and fps > 0 else 30.0
        self._output_path = output_path
        self._broadcast = broadcast
        self._codec = codec
        self._bit_rate = bit_rate
        self._options = options
        self._input_fps = input_fps or 0.0
        self._cfr = bool(cfr)
        self._format = fmt
        self._drawtext = DrawTextOverlay(drawtext) if drawtext else None
        self._scratch = None
        self._file_encoder = None
        self._ts_encoder = None
        self.ts_ring = MpegTSRing() if broadcast else None
        self._ts_last_index = -1
        self.fps = FramesPerSecond()
        # frame capture -> encoded, sliding percentiles (/metrics)
        self.latency = LatencyMeter()
        WorkPublish.__init__(self, name, frame_queue, frame_buffer, stop_event)
        Publish.__init__(self)

    def initialize(self):
        super().initialize()
        self._close_encoders()

    def _on_start(self):
        if self._output_path:
            self._file_encoder = native.Encoder(
                self._output_path, self._width, self._height,
                fps=self._fps_target, fmt=self._format, codec=self._codec,
                bit_rate=self._bit_rate, options=self._options,
                input_fps=self._input_fps, cfr=self._cfr)
        if self._broadcast:
            self._ts_encoder = native.Encoder(
                'mem:', self._width, self._height, fps=self._fps_target,
                fmt='mpegts', codec=self._codec,
                bit_rate=self._bit_rate, options=self._options,
                input_fps=self._input_fps, cfr=self._cfr)

    def _on_stop(self):
        self._close_encoders()

    def _close_encoders(self):
        for enc_attr in ('_file_encoder', '_ts_encoder'):
            enc = getattr(self, enc_attr)
            if enc is not None:
                try:
                    enc.close()
                except Exception:
                    pass
                setattr(self, enc_attr, None)

    def _new_frame(self, frame, payload):
        try:
            image = frame.image
            if self._drawtext is not None:
                # overlay on a private copy: the out frame is fanned out to
                # other subscribers (MJPEG) that must not see the stamp
                if self._scratch is None or \
                        self._scratch.shape != image.shape:
                    self._scratch = np.empty_like(image)
                np.copyto(self._scratch, image)
                try:
                    self._drawtext.apply(self._scratch)
                except Exception:
                    # a bad drawtext spec must not kill the encoder task
                    self._logger.exception(
                        'drawtext overlay failed; disabling it')
                    self._drawtext = None
                image = self._scratch
            if self._file_encoder is not None:
                self._file_encoder.write(image)
            if self._ts_encoder is not None:
                self._ts_encoder.write(image)
                self._pump_ts()
            self.fps(True)
            self.latency((time() - frame.epoch) * 1000.0)
        except IOError:
            self._logger.exception('Encode error on %s', self.name)
            self.stop_event.set()
        finally:
            frame.latch.next()

    def _pump_ts(self):
        """Drain encoder output into the TS chunk ring and fan out."""
        while True:
            data = self._ts_encoder.read_bytes(MpegTSRing.CHUNK)
            if not data:
                return
            with self._subscribers_lock:
                if len(self._subscribers) == 0:
                    continue  # draining keeps the encoder buffer bounded
            # the blocking ring scan runs OUTSIDE the registry lock: a
            # full ring (one slow viewer) must not stall every other
            # client's subscribe/unsubscribe for 0.1 s per chunk
            ring = self.ts_ring
            index = ring.buffer.select_next_ready(self._ts_last_index,
                                                  timeout=0.1)
            if index < 0:
                continue
            self._ts_last_index = index
            slot = ring.buffer.frames[index]
            flat = slot.image.reshape(-1)
            flat[:len(data)] = np.frombuffer(data, np.uint8)
            ring.lengths[index] = len(data)
            with self._subscribers_lock:
                # re-read under the lock: arming and publishing must see
                # the same subscriber set (RLock — _publish re-enters)
                n_subs = len(self._subscribers)
                if n_subs == 0:
                    continue       # slot stays READY, nothing armed
                slot.stamp()
                slot.latch.next()
                slot.latch.next(n_subs)
                count = self._publish(Payload(self.name, index))
            while count < n_subs:
                slot.latch.next()
                count += 1
