"""A reader and a writer of flax's msgpack weight files (counterpart of
the ``.msgpack`` branches of watsor_tpu/models/zoo.py ``load_weights`` and
``save_weights``, which call ``flax.serialization.msgpack_restore`` and
``flax.serialization.to_bytes``).

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

``to_bytes(tree)`` writes, byte for byte, what ``flax.serialization.to_bytes``
writes for a tree of dicts with str keys and numpy array leaves, keys in
the tree's order. It refuses what the reader would not give back as it
was: an array over flax's chunk size (flax would chunk it), a dtype
outside ``READ_DTYPES`` or a big-endian array (flax would store its bytes
under a name that reads them as little-endian), and any other leaf.
"""

import struct

import numpy as np

READ_DTYPES = ('bool', 'int8', 'int16', 'int32', 'int64', 'uint8',
               'uint16', 'uint32', 'uint64', 'float16', 'float32',
               'float64', 'bfloat16')

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = '__msgpack_chunked_array__'
# flax.serialization.MAX_CHUNK_SIZE: larger arrays are written in chunks
MAX_CHUNK_SIZE = 2 ** 30

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


# the writer: msgpack's smallest encoding of each object, as msgpack-python
# (which flax calls with use_bin_type=True) chooses it

def _header(n, fix_base, fix_limit, wide):
    """A length header: the fix form under ``fix_limit``, else the first
    of ``wide`` ((limit, first byte, struct format), ...) that holds n."""
    if n < fix_limit:
        return bytes([fix_base | n])
    for limit, code, fmt in wide:
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError('msgpack cannot hold a length of {}'.format(n))


_U8, _U16, _U32 = 0xff, 0xffff, 0xffffffff


def _uint(n):
    if n < 0x80:
        return bytes([n])
    for limit, code, fmt in ((_U8, 0xcc, '>B'), (_U16, 0xcd, '>H'),
                             (_U32, 0xce, '>I')):
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    return b'\xcf' + struct.pack('>Q', n)


def _str(text):
    data = text.encode('utf-8')
    return _header(len(data), 0xa0, 32, ((_U8, 0xd9, '>B'),
                                        (_U16, 0xda, '>H'),
                                        (_U32, 0xdb, '>I'))) + data


def _bin(data):
    return _header(len(data), 0, 0, ((_U8, 0xc4, '>B'), (_U16, 0xc5, '>H'),
                                     (_U32, 0xc6, '>I'))) + data


def _ext_bytes(code, data):
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixext:
        head = bytes([fixext[len(data)]])
    else:
        head = _header(len(data), 0, 0, ((_U8, 0xc7, '>B'),
                                         (_U16, 0xc8, '>H'),
                                         (_U32, 0xc9, '>I')))
    return head + struct.pack('>b', code) + data


def _ndarray_bytes(arr):
    """flax ``_ndarray_to_bytes``: ``[shape, dtype name, C-order bytes]``,
    refusing what would not read back as it was."""
    name = arr.dtype.name
    if name not in READ_DTYPES:
        raise ValueError('an array of dtype {!r} is not written; writable '
                         'dtypes: {}'.format(name, ', '.join(READ_DTYPES)))
    if arr.dtype.byteorder == '>':
        raise ValueError('a big-endian {} array is not written: flax would '
                         'store its bytes as little-endian'.format(name))
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError('an array of {} bytes is not written: flax chunks '
                         'arrays over {} bytes'.format(arr.nbytes,
                                                       MAX_CHUNK_SIZE))
    shape = _header(arr.ndim, 0x90, 16, ((_U16, 0xdc, '>H'),
                                         (_U32, 0xdd, '>I')))
    shape += b''.join(_uint(int(n)) for n in arr.shape)
    return b'\x93' + shape + _str(name) + _bin(arr.tobytes('C'))


def _pack(node, out):
    if isinstance(node, dict):
        out.append(_header(len(node), 0x80, 16, ((_U16, 0xde, '>H'),
                                                 (_U32, 0xdf, '>I'))))
        for key, value in node.items():
            if not isinstance(key, str):
                raise TypeError('a msgpack weight tree has str keys, not '
                                '{!r}'.format(key))
            out.append(_str(key))
            _pack(value, out)
    elif isinstance(node, np.ndarray):
        out.append(_ext_bytes(_EXT_NDARRAY, _ndarray_bytes(node)))
    else:
        raise TypeError('a msgpack weight tree holds dicts and numpy arrays, '
                        'not {}'.format(type(node).__name__))


def to_bytes(tree):
    """The bytes ``flax.serialization.to_bytes(tree)`` gives for a tree of
    dicts with str keys and numpy array leaves."""
    out = []
    _pack(tree, out)
    return b''.join(out)


def save_msgpack(path, tree):
    """Write ``tree`` to ``path`` as flax does (``to_bytes``)."""
    data = to_bytes(tree)
    with open(path, 'wb') as f:
        f.write(data)
