"""A reader for flax's msgpack weight files (counterpart of the ``.msgpack``
branch of watsor_tpu/models/zoo.py ``load_weights``, which calls
``flax.serialization.msgpack_restore``).

Pure Python and numpy: neither flax nor the ``msgpack`` package is needed.
``restore(data)`` returns what ``msgpack_restore`` returns for the files
flax writes: nested dicts with str keys, lists, the msgpack scalars (nil,
bool, int, float, str, bin), and flax's extension types

- 1, an ndarray: a msgpack array ``[shape, dtype name, raw C-order bytes]``
  (``flax.serialization._ndarray_to_bytes``), decoded as a read-only
  numpy view of the bytes;
- 2, a Python complex: ``[real, imag]``;
- 3, a numpy scalar: an ndarray of shape ``()``, returned as its scalar;

and arrays over flax's chunk size, which it stores as
``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``,
joined back. ``bfloat16`` leaves are widened to float32 (exact: a bfloat16
is the top half of a float32), since numpy has no bfloat16 without
``ml_dtypes``. Any other dtype outside ``READ_DTYPES`` raises, naming it.
"""

import struct

import numpy as np

READ_DTYPES = ('bool', 'int8', 'int16', 'int32', 'int64', 'uint8',
               'uint16', 'uint32', 'uint64', 'float16', 'float32',
               'float64', 'bfloat16')

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = '__msgpack_chunked_array__'

# fixed-width scalars: first byte -> (struct format, size)
_FIXED = {0xca: ('>f', 4), 0xcb: ('>d', 8),
          0xcc: ('>B', 1), 0xcd: ('>H', 2), 0xce: ('>I', 4), 0xcf: ('>Q', 8),
          0xd0: ('>b', 1), 0xd1: ('>h', 2), 0xd2: ('>i', 4), 0xd3: ('>q', 8)}
# length-prefixed objects: first byte -> (kind, length bytes)
_SIZED = {0xc4: ('bin', 1), 0xc5: ('bin', 2), 0xc6: ('bin', 4),
          0xc7: ('ext', 1), 0xc8: ('ext', 2), 0xc9: ('ext', 4),
          0xd9: ('str', 1), 0xda: ('str', 2), 0xdb: ('str', 4),
          0xdc: ('array', 2), 0xdd: ('array', 4),
          0xde: ('map', 2), 0xdf: ('map', 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data, raw):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw          # str payloads stay bytes (flax's ndarray)

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError('msgpack data ends inside an object')
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def uint(self, n):
        return int.from_bytes(self.take(n), 'big')

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.string(b & 0x1f)
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _FIXEXT:
            code = struct.unpack('>b', self.take(1))[0]
            return _ext(code, bytes(self.take(_FIXEXT[b])))
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.uint(width)
            if kind == 'bin':
                return bytes(self.take(n))
            if kind == 'str':
                return self.string(n)
            if kind == 'array':
                return [self.read() for _ in range(n)]
            if kind == 'map':
                return self.map(n)
            code = struct.unpack('>b', self.take(1))[0]
            return _ext(code, bytes(self.take(n)))
        raise ValueError('byte 0x{:02x} at {} starts no msgpack object'
                         .format(b, self.pos - 1))

    def string(self, n):
        chunk = bytes(self.take(n))
        return chunk if self.raw else chunk.decode('utf-8')

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unpack(data, raw=False):
    reader = _Reader(data, raw)
    value = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError('{} bytes after the msgpack object'.format(
            len(reader.data) - reader.pos))
    return value


def _ndarray(data):
    shape, name, buffer = _unpack(data, raw=True)
    name = name.decode('ascii') if isinstance(name, bytes) else name
    if name not in READ_DTYPES:
        raise ValueError('flax msgpack leaf of dtype {!r} is not read; '
                         'readable dtypes: {}'.format(
                             name, ', '.join(READ_DTYPES)))
    if name == 'bfloat16':
        bits = np.frombuffer(buffer, dtype='<u2').astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name).newbyteorder('<'),
                         ).reshape(shape)


def _ext(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        real, imag = _unpack(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError('msgpack extension type {} is not one flax writes'
                     .format(code))


def _unchunk(node):
    """Join flax's chunked arrays back, as ``msgpack_restore`` does."""
    if isinstance(node, dict):
        if node.get(_CHUNKED) is True:
            shape = tuple(node['shape'][str(i)]
                          for i in range(len(node['shape'])))
            chunks = [node['chunks'][str(i)]
                      for i in range(len(node['chunks']))]
            return np.concatenate(chunks).reshape(shape)
        return {key: _unchunk(value) for key, value in node.items()}
    return node


def restore(data):
    """The tree ``flax.serialization.msgpack_restore(data)`` gives."""
    return _unchunk(_unpack(data))


def load_msgpack(path):
    """A flax ``.msgpack`` weight file -> its variables tree."""
    with open(path, 'rb') as f:
        return restore(f.read())
