"""A small msgpack codec: the subset the checkpoint layout uses.

The reference writes its checkpoints with ``msgpack.packb(payload,
use_bin_type=True)``. The port must read and write the same files on a
machine without the ``msgpack`` package, so it carries this codec: maps,
arrays, str, bin, int, float, bool and nil, each in the smallest form
msgpack-python picks (so :func:`packb` gives the same bytes as
``msgpack.packb(obj, use_bin_type=True)``). :func:`unpackb` also reads
float32 values. Extension types, a truncated input and trailing bytes raise
``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, List

__all__ = ["packb", "unpackb"]


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n < 1 << 16:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n < 1 << 16:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, bound in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < bound:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, bound in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -bound:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def packb(obj: Any) -> bytes:
    """``obj`` → msgpack bytes (str as str, bytes as bin)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# (struct format, byte count) of the fixed-width scalars, by type byte
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
          0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
          0xD2: (">i", 4), 0xD3: (">q", 8)}
# (length format, byte count, kind) of the sized containers, by type byte
_SIZED = {0xC4: (">B", 1, "bin"), 0xC5: (">H", 2, "bin"),
          0xC6: (">I", 4, "bin"), 0xD9: (">B", 1, "str"),
          0xDA: (">H", 2, "str"), 0xDB: (">I", 4, "str"),
          0xDC: (">H", 2, "array"), 0xDD: (">I", 4, "array"),
          0xDE: (">H", 2, "map"), 0xDF: (">I", 4, "map")}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def read(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self._map(b & 0x0F)
        if b < 0xA0:
            return self._array(b & 0x0F)
        if b < 0xC0:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _SIZED:
            fmt, n, kind = _SIZED[b]
            size = struct.unpack(fmt, self.take(n))[0]
            if kind == "bin":
                return bytes(self.take(size))
            if kind == "str":
                return self._str(size)
            if kind == "array":
                return self._array(size)
            return self._map(size)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if isinstance(key, (list, dict)):
                raise ValueError("unhashable msgpack map key")
            out[key] = self.read()
        return out


def unpackb(data: bytes) -> Any:
    """msgpack bytes → the object (str decoded as UTF-8, bin as bytes)."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes "
                         "after the msgpack object")
    return obj

