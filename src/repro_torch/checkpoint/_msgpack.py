"""The part of msgpack that the checkpoint format uses, in plain Python.

:func:`packb` writes what ``msgpack.packb(obj, use_bin_type=True)``
writes, byte for byte, for ``None``, ``bool``, ``int`` (every width,
signed and unsigned), ``float`` (always float64, as msgpack-python
writes a Python float), ``str`` (str8/16/32), ``bytes`` (bin8/16/32),
``list`` / ``tuple`` (arrays) and ``dict`` (maps, in insertion order);
each value in its smallest encoding.  :func:`unpackb` reads the same
set (``str`` decoded as UTF-8, arrays as lists) and raises
``ValueError`` on an unknown type byte, truncated data or bytes left
over.  The standard library only: the port needs no msgpack package.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

_FLOAT64 = struct.Struct(">d")
# (limit of the length or value, type byte, struct format) per width.
_UINTS = ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
          (0xFFFFFFFF, 0xCE, ">I"), (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"))
_INTS = ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
         (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q"))
_STR = ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"), (0xFFFFFFFF, 0xDB, ">I"))
_BIN = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))
_ARRAY = ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I"))
_MAP = ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))


def _header(n: int, fix_base: int, fix_limit: int, widths, what: str
            ) -> bytes:
    """The type byte and length of a str, bin, array or map of ``n``
    items (a fix form below ``fix_limit`` where the type has one)."""
    if n < fix_limit:
        return bytes((fix_base | n,))
    for limit, code, fmt in widths:
        if n <= limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"{what} of length {n} is too long for msgpack")


def _int(obj: int) -> bytes:
    if 0 <= obj < 0x80 or -0x20 <= obj < 0:
        return struct.pack(">b" if obj < 0 else ">B", obj)
    for limit, code, fmt in (_UINTS if obj > 0 else _INTS):
        if (obj <= limit) if obj > 0 else (obj >= limit):
            return bytes((code,)) + struct.pack(fmt, obj)
    raise OverflowError(f"integer {obj} is out of msgpack's range")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + _FLOAT64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xA0, 32, _STR, "str") + data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_header(len(data), 0, 0, _BIN, "bin") + data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, _ARRAY, "array"))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, _MAP, "map"))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at "
                             f"offset {self.pos} of {len(self.data)}")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str) -> int:
        s = struct.Struct(fmt)
        return s.unpack(self.take(s.size))[0]


# Type byte -> (kind, struct format of the value or the length).
_FIXED = {0xCC: ("value", ">B"), 0xCD: ("value", ">H"),
          0xCE: ("value", ">I"), 0xCF: ("value", ">Q"),
          0xD0: ("value", ">b"), 0xD1: ("value", ">h"),
          0xD2: ("value", ">i"), 0xD3: ("value", ">q"),
          0xCB: ("value", ">d"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _kind(code: int, r: _Reader) -> Tuple[str, Any]:
    """(kind, value or length) of the item whose type byte is ``code``."""
    if code <= 0x7F:
        return "value", code
    if code >= 0xE0:
        return "value", code - 0x100
    if 0x80 <= code <= 0x8F:
        return "map", code & 0x0F
    if 0x90 <= code <= 0x9F:
        return "array", code & 0x0F
    if 0xA0 <= code <= 0xBF:
        return "str", code & 0x1F
    if code in (0xC0, 0xC2, 0xC3):
        return "value", {0xC0: None, 0xC2: False, 0xC3: True}[code]
    if code not in _FIXED:
        raise ValueError(f"unsupported msgpack type byte 0x{code:02x} at "
                         f"offset {r.pos - 1}")
    kind, fmt = _FIXED[code]
    return kind, r.unpack(fmt)


def _unpack(r: _Reader) -> Any:
    kind, n = _kind(r.take(1)[0], r)
    if kind == "value":
        return n
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


def unpackb(data: bytes) -> Any:
    """The one object that ``data`` holds; ``ValueError`` if the data is
    truncated, has bytes left over or holds a type outside the set."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"extra data: {len(r.data) - r.pos} bytes after "
                         f"the msgpack object")
    return obj
