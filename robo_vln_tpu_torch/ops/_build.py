"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout (the
hash is that of the source, so an edited source is rebuilt) and loaded with
``ctypes``.  Nothing is built when a module is imported: a wrapper calls
:func:`load` when it first launches its kernel, and :func:`build_all` builds
every kernel at once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("lstm_seq", "cross_modal_attn")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path):
    return [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
        "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every kernel whose library is missing, all ``nvcc`` processes
    in parallel.  Returns ``{name: compiler output}``; raises if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
