"""Tracing and profiling on ``torch.profiler`` (counterpart of
robo_vln_tpu/utils/profiling.py).

* :func:`maybe_start_trace_server` — the JAX package starts a profiler
  server for live capture on ``ROBO_VLN_PROFILE_PORT``; PyTorch has no such
  server, so a port set there (or passed) raises NotImplementedError rather
  than being ignored;
* :class:`StepTimer` — EMA per-step wall timing with periodic log lines and,
  with ``scope``, a ``record_function`` range of the timer's name around
  each step;
* :func:`trace` — a context manager writing a TensorBoard-readable trace of
  a code region (``torch.profiler.tensorboard_trace_handler``) into a
  directory;
* :func:`module_range` — the range of one module's forward, named after the
  JAX package's module: :data:`MODULE_RANGES` are the rgb and depth trunks,
  BERT and the two HCM policies, beside the steps' ``hier_train_step.*``
  ranges (training/steps.py).  Outside a profiler a range costs a few
  microseconds of host time a call.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

from .logging import logger

# the module ranges, by the JAX module each forward counts as
MODULE_RANGES = ("TVResNet50", "GNResNetEncoder", "BertEncoder", "HighLevelPolicy",
                 "LowLevelPolicy")


def maybe_start_trace_server(port: Optional[int] = None):
    """None when no port is set (``port`` or ``ROBO_VLN_PROFILE_PORT``);
    otherwise raises: torch.profiler has no server a client can capture from
    while the program runs."""
    port = port or int(os.environ.get("ROBO_VLN_PROFILE_PORT", 0))
    if port:
        raise NotImplementedError(
            f"profiler server on :{port} (ROBO_VLN_PROFILE_PORT): torch.profiler has no "
            "live-capture server; trace a region with utils.profiling.trace(log_dir)")
    return None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and, where there is one, the card) and write
    its trace into ``log_dir`` as TensorBoard's profiler plugin reads it."""
    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    logger.info(f"trace written to {log_dir}")


def module_range(name: str):
    """Decorate a forward: its calls run inside ``record_function(name)``."""
    def wrap(forward):
        @functools.wraps(forward)
        def ranged(*args, **kwargs):
            with record_function(name):
                return forward(*args, **kwargs)
        return ranged
    return wrap


class StepTimer:
    def __init__(self, name: str = "step", log_every: int = 100, ema: float = 0.98,
                 scope: bool = False):
        self.name = name
        self.log_every = log_every
        self.ema = ema
        self.scope = scope
        self._range = None
        self._avg = None
        self._count = 0
        self._t0 = None

    def __enter__(self):
        if self.scope:
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._avg = dt if self._avg is None else (
            self.ema * self._avg + (1 - self.ema) * dt
        )
        self._count += 1
        if self._count % self.log_every == 0:
            logger.info(
                f"{self.name}: {self._avg * 1000:.1f} ms/step (ema, "
                f"n={self._count})"
            )

    @property
    def average(self) -> Optional[float]:
        return self._avg
