"""Device and dtype resolution for the port's entry points."""

from __future__ import annotations

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
