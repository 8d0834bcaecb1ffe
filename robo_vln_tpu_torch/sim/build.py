"""Build and load the port's host-side C++ libraries (the kinematic
integrator and the DTW core the env layer and the measures call, and the
trajectory store the buffers are read and written through).

Each ``sim/<name>.cc`` has a plain C interface.  It is compiled with
``g++ -O3 -std=c++17 -shared -fPIC`` into ``build/sim/lib<name>-<hash>.so``
at the root of the checkout (the hash is that of the source, so an edited
source is rebuilt, as ops/_build.py names the kernels) and loaded with
``ctypes``.  Nothing is built when a module is imported: the first caller
builds.  These run on the host; they are not kernels of the card, and each
caller keeps a numpy fallback for a machine without ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sim"
LIBS = ("kinematics", "dtw", "trajstore")

_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC / f"{name}.cc").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, compiled first if missing; raises when
    it cannot be built."""
    with _LOCK:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the host libraries cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([cxx, "-O3", "-std=c++17", "-shared", "-fPIC",
                            str(SRC / f"{name}.cc"), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        lib = _libs[name] = ctypes.CDLL(str(out))
        return lib
