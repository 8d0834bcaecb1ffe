"""Episode (de)serialization: msgpack+numpy and the zero-copy flat codec (the
port's own copy of robo_vln_tpu/data/serialization.py, with its own msgpack
codec in place of the ``msgpack`` package).

Two wire formats, detected on read (:func:`unpackb_any`):

* **msgpack** (:func:`packb` / :func:`unpackb`): msgpack_numpy tagging, an
  ndarray becomes ``{b'nd': True, b'type': dtype.str, b'shape': [...],
  b'data': bytes}``, the layout the reference packs episodes in.
* **flat** (:func:`pack_flat` / :func:`unpack_flat`, magic ``RVF1``): a small
  msgpack header (structure, dtypes, shapes, offsets), then 64-byte-aligned
  raw array payloads.

The codec covers the subset these buffers use: nil, bool, integers of every
width and sign, float64 (float32 on read), str and bin of every length
class, arrays and maps.  Ext types raise.  :func:`packb` writes what
``msgpack.packb(obj, default=..., use_bin_type=True)`` writes, byte for
byte: the smallest encoding of each value, str8 enabled, Python floats
(``np.float64`` among them) as float64, other numpy scalars and arrays
through the msgpack_numpy tag.  Decoding is ``raw=False``: str as ``str``,
bin as ``bytes``, maps with keys of any type.

Both decoders return every ndarray as a read-only-iff-the-source-is view
over the source buffer (``np.frombuffer``): no array is copied.  A view
keeps the buffer alive through numpy's ``base``.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

FLAT_MAGIC = b"RVF1"
_ALIGN = 64


# -- msgpack encoder -----------------------------------------------------------

def _encode(obj: Any):
    """msgpack_numpy's tag for numpy arrays and scalars."""
    if isinstance(obj, np.ndarray):
        contiguous = np.ascontiguousarray(obj)
        return {
            b"nd": True,
            b"type": obj.dtype.str,
            b"shape": list(obj.shape),
            b"data": contiguous.tobytes(),
        }
    if isinstance(obj, np.generic):
        return {b"nd": False, b"type": obj.dtype.str, b"data": obj.tobytes()}
    raise TypeError(f"Cannot serialize {type(obj)}")


def _int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0x80 <= x <= 0xFF:
        out.append(struct.pack("BB", 0xCC, x))
    elif -0x80 <= x < 0:
        out.append(struct.pack(">Bb", 0xD0, x))
    elif 0xFF < x <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, x))
    elif -0x8000 <= x < -0x80:
        out.append(struct.pack(">Bh", 0xD1, x))
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, x))
    elif -0x80000000 <= x < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, x))
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, x))
    elif -0x8000000000000000 <= x < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, x))
    else:
        raise OverflowError("Integer value out of range")


def _header(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: fix|n up to fix_max, then the 8-, 16- and 32-bit
    forms of ``codes`` (None where a form does not exist)."""
    c8, c16, c32 = codes
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
    elif c8 is not None and n <= 0xFF:
        out.append(struct.pack("BB", c8, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", c16, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", c32, n))
    else:
        raise ValueError(f"msgpack value too large ({n})")


def _pack(out: List[bytes], obj: Any, default_used: bool = False) -> None:
    # the type tests of msgpack's packer, in its order
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, memoryview):
        _header(out, obj.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
        out.append(obj.tobytes())
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif not default_used:
        _pack(out, _encode(obj), default_used=True)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj``, numpy arrays and scalars tagged."""
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


# -- msgpack decoder -----------------------------------------------------------

_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


class _Unpacker:
    """One pass over a msgpack buffer.  A bin value is kept as a memoryview
    of the source until it is placed: an ndarray tag turns its data into a
    view, everything else into ``bytes``."""

    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        start = self.pos
        if start + n > len(self.mv):
            raise ValueError("msgpack data ends inside a value")
        self.pos = start + n
        return self.mv[start:self.pos]

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        """The next value; a bin comes back as a memoryview."""
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self._take(self._unpack((">B", ">H", ">I")[b - 0xC4]))
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if b in _INTS:
            return self._unpack(_INTS[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type 0x{b:02x} (ext or reserved) is not supported")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [_placed(self.value()) for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = _placed(self.value())
            out[key] = self.value()
        return _decode_nd(out)


def _placed(v):
    return v.tobytes() if isinstance(v, memoryview) else v


def _decode_nd(obj: dict):
    """A msgpack_numpy tag (bytes keys, or str keys from ``raw=False``
    writers) becomes its array or scalar, the data a view; any other map
    keeps its values, bins as bytes."""
    for nd, typ, shape, data in ((b"nd", b"type", b"shape", b"data"),
                                 ("nd", "type", "shape", "data")):
        if nd in obj:
            dtype = np.dtype(_placed(obj[typ]))
            if obj[nd]:
                return np.frombuffer(obj[data], dtype=dtype).reshape(obj[shape])
            return np.frombuffer(obj[data], dtype=dtype)[0]
    return {k: _placed(v) for k, v in obj.items()}


def unpackb(data) -> Any:
    """Decode msgpack ``data`` (any bytes-like / buffer-protocol object)."""
    unpacker = _Unpacker(data)
    obj = _placed(unpacker.value())
    if unpacker.pos != len(unpacker.mv):
        raise ValueError("extra data after the msgpack value")
    return obj


# -- flat format ---------------------------------------------------------------

def _flat_encode(obj, blocks):
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        blocks.append(a)
        return {"__nd__": len(blocks) - 1, "t": a.dtype.str, "s": list(a.shape)}
    if isinstance(obj, np.generic):
        return {"__np__": True, "t": obj.dtype.str, "d": obj.tobytes()}
    if isinstance(obj, dict):
        return {k: _flat_encode(v, blocks) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_flat_encode(v, blocks) for v in obj]
    return obj


def pack_flat(obj: Any) -> bytes:
    """Encode ``obj`` (nested dicts/lists/scalars/ndarrays) in the flat
    format: [RVF1][u32 header_len][msgpack header][64B-aligned payloads]."""
    blocks = []
    tree = _flat_encode(obj, blocks)
    offsets = []
    off = 0
    for a in blocks:
        offsets.append(off)
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    header = packb({"tree": tree, "off": offsets})
    base = -(-(8 + len(header)) // _ALIGN) * _ALIGN
    out = bytearray(base + off)
    out[:4] = FLAT_MAGIC
    out[4:8] = struct.pack("<I", len(header))
    out[8 : 8 + len(header)] = header
    for a, o in zip(blocks, offsets):
        if a.nbytes:
            np.frombuffer(out, a.dtype, a.size, base + o)[:] = a.ravel()
    return bytes(out)


def is_flat(data) -> bool:
    return len(data) >= 4 and bytes(data[:4]) == FLAT_MAGIC


def unpack_flat(data) -> Any:
    """Decode a flat buffer; ndarrays come back as zero-copy views into
    ``data`` (read-only iff ``data`` is)."""
    mv = memoryview(data).cast("B")
    (hlen,) = struct.unpack("<I", mv[4:8])
    header = unpackb(mv[8 : 8 + hlen])
    base = -(-(8 + hlen) // _ALIGN) * _ALIGN
    offsets = header["off"]

    def dec(node):
        if isinstance(node, dict):
            if "__nd__" in node:
                dt = np.dtype(node["t"])
                shape = node["s"]
                count = 1
                for d in shape:
                    count *= int(d)
                return np.frombuffer(
                    mv, dt, count, base + offsets[node["__nd__"]]
                ).reshape(shape)
            if "__np__" in node:
                return np.frombuffer(node["d"], np.dtype(node["t"]))[0]
            return {k: dec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [dec(v) for v in node]
        return node

    return dec(header["tree"])


def unpackb_any(data) -> Any:
    """Decode either wire format (flat detected by magic)."""
    if is_flat(data):
        return unpack_flat(data)
    return unpackb(data)
