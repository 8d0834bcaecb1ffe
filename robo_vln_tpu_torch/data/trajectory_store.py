"""Trajectory buffer: a key-value store of serialized expert episodes (the
port's own copy of the pure-Python backend of
robo_vln_tpu/data/trajectory_store.py).

On disk, a store is a directory of two append-only files, in the format the
JAX package's native store (``sim/trajstore.cc``) and its Python backend
both read and write:

* ``store.dat``: records ``[u64 key][u64 length][length bytes]``;
* ``store.idx``: entries ``[u64 key][u64 value offset][u64 length]``, the
  last entry of a key winning.

All integers are little-endian.  Values are arbitrary bytes; the episode
layout lives in data/serialization.py and data/loader.py.  The port has this
one backend; the native store waits for the eval slice's build of the C++
sources (ROADMAP §A item 3).
"""

from __future__ import annotations

import os
import struct

import numpy as np

_REC = struct.Struct("<QQQ")
_HDR = struct.Struct("<QQ")


class TrajectoryStore:
    def __init__(self, path: str, writable: bool = False):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._dat_path = os.path.join(path, "store.dat")
        self._idx_path = os.path.join(path, "store.idx")
        self._index = {}
        if os.path.exists(self._idx_path):
            with open(self._idx_path, "rb") as f:
                data = f.read()
            for off in range(0, len(data) - len(data) % _REC.size, _REC.size):
                key, doff, dlen = _REC.unpack_from(data, off)
                self._index[key] = (doff, dlen)
        open(self._dat_path, "ab").close()
        self._dat_w = open(self._dat_path, "ab") if writable else None
        self._idx_w = open(self._idx_path, "ab") if writable else None
        self._dat_r = open(self._dat_path, "rb")
        self._size = os.path.getsize(self._dat_path)

    def put(self, key: int, data: bytes) -> None:
        if self._dat_w is None:
            raise IOError(f"trajectory store {self.path} was opened read-only")
        off = self._size + _HDR.size
        self._dat_w.write(_HDR.pack(key, len(data)))
        self._dat_w.write(data)
        self._idx_w.write(_REC.pack(key, off, len(data)))
        self._size += _HDR.size + len(data)
        self._index[key] = (off, len(data))

    def get_buffer(self, key: int) -> np.ndarray:
        """The value as a (n,) uint8 array, read with one copy; decode it
        zero-copy with data/serialization.unpackb_any."""
        off, n = self._index[key]
        if self._dat_w:
            self._dat_w.flush()
        self._dat_r.seek(off)
        buf = np.empty(n, np.uint8)
        read = self._dat_r.readinto(memoryview(buf))
        if read != n:
            raise IOError(f"short read: {read}/{n} bytes for key {key}")
        return buf

    def get(self, key: int) -> bytes:
        return self.get_buffer(key).tobytes()

    def __len__(self) -> int:
        return len(self._index)

    def flush(self) -> None:
        if self._dat_w:
            self._dat_w.flush()
            self._idx_w.flush()

    def close(self) -> None:
        for f in (self._dat_w, self._idx_w, self._dat_r):
            if f:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
