"""A stdlib-only msgpack codec for flax ``to_bytes`` checkpoints.

A released model stores its weights as ``model_best.msgpack``: the msgpack
encoding of ``{"params": tree}`` that ``flax.serialization.to_bytes`` writes.
Maps hold string keys; every array leaf is ExtType 1 whose payload is itself
msgpack of ``(shape, dtype.name, C-order bytes)``. This module reads and
writes that format with ``struct`` alone, so the port needs neither flax nor
the ``msgpack`` package (which GPU hosts may lack).

``unpackb`` returns what ``flax.serialization.msgpack_restore`` returns:
dicts, lists, str, int, float, bool, None and numpy arrays (ExtType 1) or
numpy scalars (ExtType 3). ``packb`` uses msgpack-python's smallest-encoding
rules, so a tree of numpy arrays packs to the same bytes as
``flax.serialization.msgpack_serialize``.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---------------------------------------------------------------------- #
# decoding
# ---------------------------------------------------------------------- #


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def string(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _decode_ext(code, self.take(n))

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        simple = {
            0xC4: lambda: self.take(self.unpack("B")),
            0xC5: lambda: self.take(self.unpack("H")),
            0xC6: lambda: self.take(self.unpack("I")),
            0xC7: lambda: self.ext(self.unpack("B")),
            0xC8: lambda: self.ext(self.unpack("H")),
            0xC9: lambda: self.ext(self.unpack("I")),
            0xCA: lambda: self.unpack("f"),
            0xCB: lambda: self.unpack("d"),
            0xCC: lambda: self.unpack("B"),
            0xCD: lambda: self.unpack("H"),
            0xCE: lambda: self.unpack("I"),
            0xCF: lambda: self.unpack("Q"),
            0xD0: lambda: self.unpack("b"),
            0xD1: lambda: self.unpack("h"),
            0xD2: lambda: self.unpack("i"),
            0xD3: lambda: self.unpack("q"),
            0xD4: lambda: self.ext(1),
            0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.string(self.unpack("B")),
            0xDA: lambda: self.string(self.unpack("H")),
            0xDB: lambda: self.string(self.unpack("I")),
            0xDC: lambda: [self.value() for _ in range(self.unpack("H"))],
            0xDD: lambda: [self.value() for _ in range(self.unpack("I"))],
            0xDE: lambda: self.map(self.unpack("H")),
            0xDF: lambda: self.map(self.unpack("I")),
        }
        if b not in simple:
            raise ValueError("invalid msgpack type byte 0x%02x" % b)
        return simple[b]()

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _decode_ext(code: int, data: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError("unsupported msgpack ext type %d" % code)
    shape, dtype_name, buffer = _unpack_all(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 array leaves are not supported")
    arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order="C")
    return arr if code == EXT_NDARRAY else arr[()]


def _unpack_all(data: bytes, raw: bool):
    r = _Reader(data, raw)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack value")
    return out


def unpackb(data: bytes):
    """Decode a flax msgpack payload (the ``msgpack_restore`` contract)."""
    out = _unpack_all(data, raw=False)
    if _has_chunked(out):
        raise ValueError("chunked (>1 GiB) array leaves are not supported")
    return out


def _has_chunked(d) -> bool:
    return isinstance(d, dict) and (
        "__msgpack_chunked_array__" in d
        or any(_has_chunked(v) for v in d.values()))


# ---------------------------------------------------------------------- #
# encoding
# ---------------------------------------------------------------------- #


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return struct.pack(">B", v)
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for tag, fmt, hi in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                             (0xCE, "I", 0xFFFFFFFF), (0xCF, "Q", 2**64 - 1)):
            if v <= hi:
                return struct.pack(">B" + fmt, tag, v)
    else:
        for tag, fmt, lo in ((0xD0, "b", -(2**7)), (0xD1, "h", -(2**15)),
                             (0xD2, "i", -(2**31)), (0xD3, "q", -(2**63))):
            if v >= lo:
                return struct.pack(">B" + fmt, tag, v)
    raise OverflowError("integer out of msgpack range: %d" % v)


def _pack_len(n: int, fix_base, fix_max, tags) -> bytes:
    if fix_base is not None and n <= fix_max:
        return struct.pack(">B", fix_base | n)
    for tag, fmt, hi in tags:
        if n <= hi:
            return struct.pack(">B" + fmt, tag, n)
    raise ValueError("msgpack object too large (%d)" % n)


_STR_TAGS = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN_TAGS = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARR_TAGS = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP_TAGS = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    if n in _FIXEXT:
        head = struct.pack(">Bb", _FIXEXT[n], code)
    elif n <= 0xFF:
        head = struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        head = struct.pack(">BHb", 0xC8, n, code)
    else:
        head = struct.pack(">BIb", 0xC9, n, code)
    return head + data


def _pack(obj, out: list) -> None:
    # numpy first: np.float64 subclasses float, but flax packs it as ExtType 3
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.nbytes > 2**30:
            raise ValueError("cannot pack array of dtype %s, %d bytes"
                             % (arr.dtype, arr.nbytes))
        inner = packb((tuple(int(s) for s in arr.shape), arr.dtype.name,
                       arr.tobytes("C")))
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        out.append(_pack_ext(code, inner))
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_pack_len(len(b), 0xA0, 31, _STR_TAGS) + b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_pack_len(len(obj), None, -1, _BIN_TAGS) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, _ARR_TAGS))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), 0x80, 15, _MAP_TAGS))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError("cannot msgpack-encode %r" % type(obj))


def packb(obj) -> bytes:
    """Encode a tree of dict/list/str/bytes/int/float/bool/None and numpy
    array leaves the way ``flax.serialization.msgpack_serialize`` does."""
    out = []
    _pack(obj, out)
    return b"".join(out)
