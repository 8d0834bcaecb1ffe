"""Device and dtype resolution for the port's entry points, and the scope
that keeps float32 compute in float32."""

from __future__ import annotations

import contextlib

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device="cuda") -> torch.device:
    """The device to run on.  A CUDA device that is absent raises: the port
    never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its config name ("bfloat16", "float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {dtype!r}") from None


@contextlib.contextmanager
def float32_exact(dtype):
    """For float32 compute, TF32 off in cuDNN (the convolutions) and in
    matmuls for the duration of the block, then both flags restored: torch's
    default lets cuDNN round float32 convolution inputs to TF32, about 1e-3
    relative error against the JAX package's float32.  bfloat16 compute
    leaves both flags alone.  Never set globally.  The two flags are saved
    and set one by one: ``torch.backends.cudnn.flags`` would also reset every
    other cuDNN flag to its own defaults (``enabled=False`` among them) for
    the block."""
    if dtype != torch.float32:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
