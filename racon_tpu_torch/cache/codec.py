"""Self-describing value encoding for the result cache (JAX package:
racon_tpu/cache/codec.py, byte for byte the same format).

The cache stores encoded blobs, not live objects: byte accounting is
then exact (the LRU budget bounds real memory), the persistent tier
appends the same bytes it holds in memory, and a decode is the only
thing a hit costs.  The format is a small tagged tree, enough for the
unit results of the polish:

* POA window:    ``(consensus_bytes | None, polished_bool)``
* WFA pair:      ``(tape_row ndarray, n_entries, distance)``
* banded pair:   ``(moves_row ndarray, path_len, distance)``
* scan pair:     ``(lengths ndarray, codes ndarray)`` or ``None``

Tags: N=None T=True F=False I=int(le64) Y=bytes S=str(utf8)
A=ndarray(dtype-str + shape + raw bytes) L=sequence (decoded as a
tuple).  ``decode`` raises :class:`CodecError` on any malformed input:
a corrupt persistent frame must read as a miss, never as wrong bytes.
"""

from __future__ import annotations

import struct

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")


class CodecError(ValueError):
    """Blob does not decode cleanly; callers treat it as a miss."""


def _enc(value, out: list) -> None:
    if value is None:
        out.append(b"N")
    elif value is True:
        out.append(b"T")
    elif value is False:
        out.append(b"F")
    elif isinstance(value, int):
        out.append(b"I" + _I64.pack(value))
    elif isinstance(value, (bytes, bytearray, memoryview)):
        b = bytes(value)
        out.append(b"Y" + _U32.pack(len(b)) + b)
    elif isinstance(value, str):
        b = value.encode()
        out.append(b"S" + _U32.pack(len(b)) + b)
    elif isinstance(value, (tuple, list)):
        out.append(b"L" + _U32.pack(len(value)))
        for v in value:
            _enc(v, out)
    else:
        import numpy as np

        if isinstance(value, np.integer):
            out.append(b"I" + _I64.pack(int(value)))
            return
        a = np.ascontiguousarray(value)
        ds = a.dtype.str.encode()
        raw = a.tobytes()
        out.append(b"A" + _U32.pack(len(ds)) + ds
                   + _U32.pack(a.ndim)
                   + b"".join(_U32.pack(d) for d in a.shape)
                   + _U32.pack(len(raw)) + raw)


def encode(value) -> bytes:
    parts: list = []
    _enc(value, parts)
    return b"".join(parts)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise CodecError("truncated blob")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]


def _dec(r: _Reader):
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"I":
        return _I64.unpack(r.take(8))[0]
    if tag == b"Y":
        return r.take(r.u32())
    if tag == b"S":
        return r.take(r.u32()).decode()
    if tag == b"L":
        n = r.u32()
        if n > len(r.buf):
            raise CodecError("implausible sequence length")
        return tuple(_dec(r) for _ in range(n))
    if tag == b"A":
        import numpy as np

        ds = r.take(r.u32()).decode()
        ndim = r.u32()
        if ndim > 8:
            raise CodecError("implausible ndarray rank")
        shape = tuple(r.u32() for _ in range(ndim))
        raw = r.take(r.u32())
        try:
            a = np.frombuffer(raw, dtype=np.dtype(ds))
            # copy: frombuffer views are read-only, and consumers
            # (op-tape replay, run decoding) expect ordinary arrays
            return a.reshape(shape).copy()
        except (TypeError, ValueError) as exc:
            raise CodecError(f"bad ndarray blob: {exc}") from exc
    raise CodecError(f"unknown tag {tag!r}")


def decode(blob: bytes):
    r = _Reader(blob)
    value = _dec(r)
    if r.pos != len(blob):
        raise CodecError("trailing bytes after value")
    return value
