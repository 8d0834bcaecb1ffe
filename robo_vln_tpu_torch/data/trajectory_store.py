"""Trajectory buffer: a key-value store of serialized expert episodes (the
port's own copy of robo_vln_tpu/data/trajectory_store.py).

On disk, a store is a directory of two append-only files, in the format the
JAX package's stores read and write:

* ``store.dat``: records ``[u64 key][u64 length][length bytes]``;
* ``store.idx``: entries ``[u64 key][u64 value offset][u64 length]``, the
  last entry of a key winning.

All integers are little-endian.  Values are arbitrary bytes; the episode
layout lives in data/serialization.py and data/loader.py.

Two backends read and write these files alike: the native store
(``sim/trajstore.cc``: appends through stdio, reads by one ``memcpy`` out
of an mmap of ``store.dat``; built by ``sim/build.py`` into ``build/sim/``
on first use) and a pure-Python one.  :class:`TrajectoryStore` takes the
native one unless ``g++`` is missing (the build fails) or the environment
variable ``ROBO_VLN_STORE_BACKEND`` names another backend than ``native``,
as the JAX package's facade does.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import Optional

import numpy as np

_REC = struct.Struct("<QQQ")
_HDR = struct.Struct("<QQ")
BACKEND_VAR = "ROBO_VLN_STORE_BACKEND"


def _native_lib():
    from ..sim.build import load

    lib = load("trajstore")
    lib.ts_open.restype = ctypes.c_void_p
    lib.ts_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ts_put.restype = ctypes.c_int
    lib.ts_put.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
                           ctypes.c_uint64]
    lib.ts_get_len.restype = ctypes.c_int64
    lib.ts_get_len.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ts_get.restype = ctypes.c_int
    lib.ts_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    lib.ts_count.restype = ctypes.c_uint64
    lib.ts_count.argtypes = [ctypes.c_void_p]
    lib.ts_flush.restype = ctypes.c_int
    lib.ts_flush.argtypes = [ctypes.c_void_p]
    lib.ts_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeStore:
    """The C++ store behind ctypes; raises when it cannot be built or the
    directory cannot be opened."""

    def __init__(self, path: str, writable: bool):
        self.path = path
        self._lib = _native_lib()
        self._h = self._lib.ts_open(path.encode(), 1 if writable else 0)
        if not self._h:
            raise IOError(f"cannot open trajectory store at {path}")
        self._writable = writable

    def put(self, key: int, data: bytes) -> None:
        if not self._writable:
            raise IOError(f"trajectory store {self.path} was opened read-only")
        rc = self._lib.ts_put(self._h, key, data, len(data))
        if rc != 0:
            raise IOError(f"ts_put failed rc={rc}")

    def get_buffer(self, key: int) -> np.ndarray:
        n = self._lib.ts_get_len(self._h, key)
        if n < 0:
            raise KeyError(key)
        buf = np.empty(n, np.uint8)
        rc = self._lib.ts_get(self._h, key,
                              buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
        if rc != 0:
            raise IOError(f"ts_get failed rc={rc}")
        return buf

    def __len__(self) -> int:
        return int(self._lib.ts_count(self._h))

    def flush(self) -> None:
        self._lib.ts_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ts_close(self._h)
            self._h = None


class PythonStore:
    """The same files, in pure Python."""

    def __init__(self, path: str, writable: bool):
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
        off, n = self._index[key]
        if self._dat_w:
            self._dat_w.flush()
        self._dat_r.seek(off)
        buf = np.empty(n, np.uint8)
        read = self._dat_r.readinto(memoryview(buf))
        if read != n:
            raise IOError(f"short read: {read}/{n} bytes for key {key}")
        return buf

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


class TrajectoryStore:
    """The store at ``path`` through ``backend`` ("native" or "python"; by
    default ``$ROBO_VLN_STORE_BACKEND``, else "native").  The native
    backend falls back to the Python one where it cannot be built."""

    def __init__(self, path: str, writable: bool = False, backend: Optional[str] = None):
        self.path = path
        if backend is None:
            backend = os.environ.get(BACKEND_VAR, "native")
        self._impl = None
        if backend == "native":
            try:
                self._impl = NativeStore(path, writable)
            except (OSError, RuntimeError, subprocess.SubprocessError):
                pass  # not built (no g++) or not opened: the Python backend reads the same files
        if self._impl is None:
            self._impl = PythonStore(path, writable)

    @property
    def backend(self) -> str:
        return "native" if isinstance(self._impl, NativeStore) else "python"

    def put(self, key: int, data: bytes) -> None:
        self._impl.put(key, data)

    def get_buffer(self, key: int) -> np.ndarray:
        """The value as a (n,) uint8 array, read with one copy; decode it
        zero-copy with data/serialization.unpackb_any."""
        return self._impl.get_buffer(key)

    def get(self, key: int) -> bytes:
        return self.get_buffer(key).tobytes()

    def __len__(self) -> int:
        return len(self._impl)

    def flush(self) -> None:
        self._impl.flush()

    def close(self) -> None:
        self._impl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
