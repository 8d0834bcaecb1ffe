"""Process-parallel decode + collate for trajectory buffers (the port's own
copy of robo_vln_tpu/data/parallel_loader.py: for the same buffer, seed and
worker count it yields the JAX package's batch stream bitwise).

The reference ships a single-worker torch DataLoader (num_workers=1,
robo_vln_trainer.py:919-927).  Feature-mode training runs fast enough on the
chip that one host core becomes the limiter at B>=16
(benchmarks/input_pipeline.py, VERDICT r3 next #4), and batches are large
(B=16, T=100 f16 trunk features ~ 330 MB), so the worker->parent transport
must not re-copy: workers collate STRAIGHT INTO SharedMemory segments
(collate_batch's ``alloc`` hook) and the parent wraps the segment zero-copy.
A finalizer on the wrapper arrays returns each segment to its worker's free
pool once the training step has consumed the batch, bounding memory at
``segments_per_worker`` max-bucket batches per worker.

Worker sharding is round-robin by episode index (the collection-worker
pattern, envs/collection.py); each worker block-shuffles and length-buckets
within its shard, and the parent drains workers round-robin, so the batch
stream is deterministic for a fixed (seed, num_workers) — changing
num_workers changes batch order, exactly like a torch DataLoader.  With
``rows`` a worker collates only those rows of each batch (a rank's share of
the global batch on the data-parallel mesh), so each rank's segments hold
its rows alone.
"""

import atexit
import functools
import gc
import multiprocessing as mp
import queue as queue_mod
import weakref
from multiprocessing import shared_memory
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import logger
from .loader import SENSOR_DTYPES, TrajectoryDataset, batch_iterator, collate_batch
from .trajectory_store import TrajectoryStore


class _SegmentAlloc:
    """collate_batch allocator carving arrays out of one shm segment."""

    def __init__(self, buf):
        self.buf = buf
        self.offset = 0
        self.meta = []

    def __call__(self, key: str, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        # 64-byte alignment keeps views cheap for downstream consumers
        start = (self.offset + 63) & ~63
        end = start + nbytes
        if end > len(self.buf):
            raise MemoryError(
                f"segment too small: need {end} bytes for {key}{shape}"
            )
        arr = np.frombuffer(self.buf, dtype, count=int(np.prod(shape)),
                            offset=start).reshape(shape)
        self.offset = end
        self.meta.append((key, tuple(shape), dtype.str, start))
        return arr


def _segment_bytes(dataset: TrajectoryDataset, batch_size: int,
                   buckets: Sequence[int], max_instruction_len: int) -> int:
    """Worst-case collated-batch bytes (largest bucket), from one decoded
    episode's per-frame shapes."""
    with TrajectoryStore(dataset.features_dir) as store:
        obs, prev, _, _ = dataset._decode(store.get_buffer(0))
    t_max = max(buckets)
    total = 0
    for k, v in obs.items():
        v = np.asarray(v)
        if k == "instruction":
            continue
        if k == "instruction_embedding":
            per = max_instruction_len * int(np.prod(v.shape[1:]))
            dt = np.dtype(np.float16)
        else:
            per = t_max * int(np.prod(v.shape[1:]))
            dt = np.dtype(SENSOR_DTYPES.get(k, np.float32))
        total += batch_size * per * dt.itemsize + 64
    # small fixed-size arrays (instruction/prev/corrected/stop/masks) ride
    # the metadata queue instead of the segment; leave headroom anyway
    return total + (1 << 20)


def _loader_worker(features_dir: str, batch_size: int, buckets,
                   max_instruction_len: int, is_bert: bool, use_iw: bool,
                   inflection_weight_coef: float, seed: int, worker_idx: int,
                   num_workers: int, segment_names, free_q, out_q,
                   rows=None) -> None:
    """Child-process body: decode+collate this worker's episode shard into
    shared-memory segments.  Imports no torch (spawned, like collection's
    workers)."""
    try:
        dataset = TrajectoryDataset(
            features_dir, batch_size=batch_size, is_bert=is_bert,
            use_iw=use_iw, inflection_weight_coef=inflection_weight_coef,
            seed=seed + worker_idx,
            indices=list(range(worker_idx, _store_len(features_dir),
                               num_workers)),
        )
        segments = {
            name: shared_memory.SharedMemory(name=name)
            for name in segment_names
        }
        buf = []

        def ship(samples, pad_to_batch=None):
            name = free_q.get()
            alloc = _SegmentAlloc(segments[name].buf)
            batch = collate_batch(
                samples, buckets, max_instruction_len,
                pad_to_batch=pad_to_batch, alloc=alloc, rows=rows,
            )
            small = {k: v for k, v in batch.items()
                     if not any(m[0] == k for m in alloc.meta)}
            out_q.put(("batch", name, alloc.meta, small))

        for sample in dataset:
            buf.append(sample)
            if len(buf) == batch_size:
                ship(buf)
                buf = []
        if buf:
            ship(buf, pad_to_batch=batch_size)
        out_q.put(("done", None, None, None))
    except Exception as e:  # propagate, never hang the parent
        import traceback

        out_q.put(("error", None, None,
                   f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def _store_len(features_dir: str) -> int:
    with TrajectoryStore(features_dir) as store:
        return len(store)


def parallel_batch_iterator(
    features_dir: str,
    batch_size: int,
    buckets: Sequence[int],
    max_instruction_len: int = 200,
    *,
    num_workers: int,
    seed: int = 0,
    is_bert: bool = False,
    use_iw: bool = True,
    inflection_weight_coef: float = 1.0,
    segments_per_worker: int = 2,
    stall_timeout_s: float = 300.0,
    rows: Optional[Tuple[int, int]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield collated static-shape batches produced by ``num_workers``
    decode/collate processes (see module docstring), each cut to ``rows``
    when given (loader.collate_batch).  Falls back to the in-process
    iterator when num_workers <= 1 or the buffer is tiny."""
    n_eps = _store_len(features_dir)
    if num_workers <= 1 or n_eps < 2 * num_workers:
        dataset = TrajectoryDataset(
            features_dir, batch_size=batch_size, is_bert=is_bert,
            use_iw=use_iw, inflection_weight_coef=inflection_weight_coef,
            seed=seed,
        )
        yield from batch_iterator(
            dataset, batch_size, buckets, max_instruction_len, rows=rows
        )
        return

    probe = TrajectoryDataset(
        features_dir, batch_size=batch_size, is_bert=is_bert,
        use_iw=use_iw, inflection_weight_coef=inflection_weight_coef,
        seed=seed,
    )
    seg_bytes = _segment_bytes(probe, batch_size if rows is None
                               else rows[1] - rows[0], buckets,
                               max_instruction_len)
    ctx = mp.get_context("spawn")
    workers = []
    all_segments = []
    logger.info(
        f"parallel loader: {num_workers} workers x {segments_per_worker} "
        f"segments x {seg_bytes / 1e6:.0f} MB over {n_eps} episodes"
    )
    try:
        for w in range(num_workers):
            segs = {}
            free_q = ctx.Queue()
            for _ in range(segments_per_worker):
                shm = shared_memory.SharedMemory(create=True, size=seg_bytes)
                all_segments.append(shm)
                segs[shm.name] = shm
                free_q.put(shm.name)
            out_q = ctx.Queue(maxsize=segments_per_worker)
            proc = ctx.Process(
                target=_loader_worker,
                args=(features_dir, batch_size, list(buckets),
                      max_instruction_len, is_bert, use_iw,
                      inflection_weight_coef, seed, w, num_workers,
                      list(segs), free_q, out_q, rows),
                daemon=True,
            )
            proc.start()
            workers.append({"proc": proc, "out": out_q, "free": free_q,
                            "segments": segs, "done": False})

        live = num_workers
        w = 0
        while live:
            worker = workers[w % num_workers]
            w += 1
            if worker["done"]:
                continue
            poll_s = max(min(20.0, stall_timeout_s / 5.0), 0.1)
            stalls = 0
            while True:
                try:
                    kind, name, meta, small = worker["out"].get(
                        timeout=poll_s
                    )
                    break
                except queue_mod.Empty:
                    if not worker["proc"].is_alive():
                        raise RuntimeError(
                            "loader worker died without reporting an error"
                        )
                    stalls += 1
                    if stalls == 1:
                        # benign cause first: reference cycles can delay the
                        # segment finalizers past the consumer's actual use —
                        # a collection fires them and unblocks the worker
                        gc.collect()
                    if stalls * poll_s >= stall_timeout_s:
                        # the worker is alive but has shipped nothing for
                        # stall_timeout_s: its free-segment pool is exhausted
                        # (it blocks on free_q.get() until the consumer drops
                        # its batch references) — a silent livelock without
                        # this diagnostic (ADVICE r4)
                        raise RuntimeError(
                            f"loader worker {(w - 1) % num_workers} produced "
                            f"nothing for {stalls * poll_s:.0f}s: its "
                            f"{segments_per_worker}-segment free pool is "
                            "likely exhausted because the consumer still "
                            f"holds >= {segments_per_worker} live batches "
                            "from it (deeper prefetch, cached arrays, or "
                            "delayed GC). Drop batch references promptly or "
                            "raise segments_per_worker."
                        )
                    if stalls * poll_s >= 40.0 and stalls % 3 == 0:
                        logger.warning(
                            f"parallel loader: worker {(w - 1) % num_workers}"
                            f" stalled {stalls * poll_s:.0f}s waiting for a "
                            "free shared-memory segment"
                        )
            if kind == "done":
                worker["done"] = True
                live -= 1
                continue
            if kind == "error":
                raise RuntimeError(f"loader worker failed: {small}")
            shm = worker["segments"][name]
            batch = dict(small)
            holders = []
            for key, shape, dtype_str, start in meta:
                arr = np.frombuffer(
                    shm.buf, np.dtype(dtype_str),
                    count=int(np.prod(shape)), offset=start,
                ).reshape(shape).view(_ShmArray)
                batch[key] = arr
                holders.append(arr)
            # segment returns to the worker's pool only after every consumer
            # view of these arrays is gone (split_tbptt windows, device_put
            # staging) — views keep their base alive through .base chains,
            # and the finalizer fires when the last reference drops.
            # functools.partial binds THIS message's queue+name: a lambda
            # closing over the loop variables would release whichever
            # segment was read most recently (late binding), letting the
            # worker overwrite data the consumer is still reading.
            _attach_release(
                holders, functools.partial(worker["free"].put, name)
            )
            yield batch
    finally:
        for worker in workers:
            if worker["proc"].is_alive():
                worker["proc"].terminate()
        for worker in workers:
            worker["proc"].join(timeout=30)
        for shm in all_segments:
            try:
                shm.unlink()  # name gone; memory frees with the last mapping
            except FileNotFoundError:
                pass
            _close_or_defer(shm)


# segments whose mmap could not close yet because a consumer still holds
# views (typically the FINAL batch, alive past the generator's finally).
# Keeping the objects referenced avoids GC-time __del__ BufferError noise;
# they are retried on later teardowns and at exit, and the memory itself is
# already unlinked (freed with the last mapping either way).
_DEFERRED_CLOSE = []


def _close_or_defer(shm) -> None:
    still_deferred = []
    for old in _DEFERRED_CLOSE:
        try:
            old.close()
        except BufferError:
            still_deferred.append(old)
    _DEFERRED_CLOSE[:] = still_deferred
    try:
        shm.close()
    except BufferError:
        _DEFERRED_CLOSE.append(shm)


def _close_deferred_at_exit() -> None:
    for shm in _DEFERRED_CLOSE:
        try:
            shm.close()
        except BufferError:
            pass


atexit.register(_close_deferred_at_exit)


class _ShmArray(np.ndarray):
    """ndarray view type that supports weak references (plain ndarrays do
    not), so the parent can finalize shared-memory segments by refcount."""


class _ReleaseGroup:
    """Calls ``release`` once every tracked array has been collected."""

    def __init__(self, n, release):
        self.remaining = n
        self.release = release

    def one_done(self):
        self.remaining -= 1
        if self.remaining == 0:
            try:
                self.release()
            except Exception:  # teardown race: queue already closed
                pass


def _attach_release(arrays, release) -> None:
    group = _ReleaseGroup(len(arrays), release)
    for arr in arrays:
        weakref.finalize(arr, group.one_done)
