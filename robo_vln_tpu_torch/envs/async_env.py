"""The eval's env pool and the trainer's TBPTT-window prefetch (counterpart
of ``AsyncEnvPool`` and ``window_stream`` in robo_vln_tpu/envs/async_env.py).

:class:`AsyncEnvPool` steps N envs from a thread pool (habitat.VectorEnv's
API: reset, async_step + wait_step), so the host's bookkeeping
overlaps the envs' steps; threads, because the kinematic sim is C++ behind
ctypes (which releases the GIL) and the rest is numpy.

In :func:`window_stream`, a worker thread decodes and collates the next
batch, splits it into windows and copies each window to the trainer's
device one window ahead of the step, so the host's decode and the copy
overlap the device's compute.

On a CUDA device (:func:`device_transfer`) the worker copies each array
into pinned host memory and from there to the device with
``non_blocking=True`` on a side stream it owns, then records an event on
that stream.  The consumer makes its own stream wait on the event before
the step reads the window (without the wait, a step could read a window
before its copy lands) and marks every tensor as used on its stream with
``record_stream`` (without it, the caching allocator could hand the memory
to the side stream's next copy while the step still reads it).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Window = Dict[str, torch.Tensor]


class AsyncEnvPool:
    def __init__(self, envs: Sequence, max_workers: Optional[int] = None):
        self.envs = list(envs)
        self._pool = ThreadPoolExecutor(max_workers=max_workers or len(envs))
        self._pending = None

    def reset(self) -> List:
        futures = [self._pool.submit(e.reset) for e in self.envs]
        return [f.result() for f in futures]

    def reset_at(self, idx: int):
        return self.envs[idx].reset()

    def async_step(self, actions: Sequence) -> None:
        assert self._pending is None, "previous step not collected"
        self._pending = [
            self._pool.submit(e.step, a) for e, a in zip(self.envs, actions)
        ]

    def wait_step(self) -> List:
        assert self._pending is not None, "no step in flight"
        out = [f.result() for f in self._pending]
        self._pending = None
        return out

    def close(self) -> None:
        for e in self.envs:
            e.close()
        self._pool.shutdown(wait=False)


def device_transfer(device) -> Tuple[Callable, Optional[Callable]]:
    """(send, receive) for :func:`window_stream`: ``send`` turns a numpy
    window into tensors on ``device`` (run on the worker thread),
    ``receive`` readies them for the consumer's stream (None on the CPU,
    where the tensors share the numpy arrays' memory)."""
    device = torch.device(device)
    if device.type != "cuda":
        return (lambda window: {k: torch.from_numpy(np.asarray(v))
                                for k, v in window.items()}), None
    side = torch.cuda.Stream(device)

    def send(window):
        out = {}
        with torch.cuda.stream(side):
            for k, v in window.items():
                src = torch.from_numpy(np.asarray(v))
                pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                pinned.copy_(src)
                out[k] = pinned.to(device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        return out, copied

    def receive(item) -> Window:
        out, copied = item
        stream = torch.cuda.current_stream(device)
        stream.wait_event(copied)
        for t in out.values():
            t.record_stream(stream)
        return out

    return send, receive


def window_stream(batches, shard_fn, split_fn, receive_fn=None):
    """Yields (is_first_window_of_batch, window): the worker thread runs
    ``split_fn`` over each batch of ``batches`` and ``shard_fn`` over each
    window, up to two windows ahead of the consumer; ``receive_fn``, when
    given, runs on the consumer's thread before each window is yielded.  A
    worker exception is raised in the consumer.  When the consumer stops
    early, the worker is stopped and joined."""
    q = queue.Queue(maxsize=2)  # two windows in flight + one consuming
    done = object()
    err = []
    stop = threading.Event()

    def worker():
        try:
            for batch in batches:
                first = True
                for w in split_fn(batch):
                    if stop.is_set():
                        return
                    q.put((first, shard_fn(w)))
                    first = False
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=worker, name="window_stream", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            first, window = item
            yield first, (receive_fn(window) if receive_fn is not None else window)
    finally:
        stop.set()
        while thread.is_alive():  # unblock a worker waiting on a full queue
            try:
                q.get(timeout=0.01)
            except queue.Empty:
                pass
        thread.join()
