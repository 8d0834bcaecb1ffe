"""The port's process-parallel loader (data/parallel_loader.py) against the
JAX package's, and both trainers through it (DAGGER.LOADER_WORKERS > 1).

* For the same buffer, seed and worker count (2 and 3), the port's batch
  stream is the JAX package's, bitwise: the same keys, dtypes, shapes and
  bytes, batch by batch.  Its episodes are the in-process loader's as a
  multiset.
* Segments recycle: 12 batches through 2 workers of 2 segments each, every
  batch read and dropped, and no segment is left in /dev/shm after the
  stream ends or after it is closed half read.
* A worker's error (a corrupt episode only a worker decodes) reaches the
  consumer; a consumer that keeps every batch exhausts the pool and gets
  the stall diagnostic instead of a hang.
* On the CPU the trainer's path wraps a batch's arrays with no copy
  (envs/async_env.device_transfer): tensors taken from a batch keep its
  segment, so later batches never overwrite them.
* A rank's rows (``rows``, as the trainers ask for them on the mesh) are
  those rows of the whole stream's batches, bitwise and at the whole
  batch's bucket, through either loader, a rank whose rows are all padding
  included.
* Both trainers train an epoch with LOADER_WORKERS 2 (finite losses, a
  checkpoint, every episode read).

No assertion depends on which worker finishes first: the loader drains its
workers round-robin, so the stream is fixed by (seed, workers).
"""

import gc
import json
import os
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from robo_vln_tpu.data.parallel_loader import parallel_batch_iterator as jax_parallel
from robo_vln_tpu_torch.data import parallel_loader
from robo_vln_tpu_torch.data.loader import (TrajectoryDataset, batch_iterator, split_tbptt,
                                            write_episode)
from robo_vln_tpu_torch.data.parallel_loader import parallel_batch_iterator
from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
from robo_vln_tpu_torch.envs.async_env import device_transfer
from tests.test_data import _make_episode
from tests.test_torch_threads import one_torch_thread  # noqa: F401

BUCKETS = [6, 10]
L = 12


def _build_store(path, n_eps, seed=0):
    rng = np.random.default_rng(seed)
    with TrajectoryStore(str(path), writable=True) as store:
        for k in range(n_eps):
            write_episode(store, k, *_make_episode(rng, int(rng.integers(4, 10))), flat=k % 3 == 0)
    return str(path)


def _fingerprints(batches):
    """(instruction id, steps, rgb sum) of every real episode of a stream."""
    out = []
    for b in batches:
        for i in range(b["valid_mask"].shape[0]):
            n = int(b["valid_mask"][i].sum())
            if n:
                out.append((int(b["instruction"][i, 0]), n,
                            round(float(b["rgb"][i, :n].astype(np.float64).sum()), 3)))
    return sorted(out)


@pytest.fixture
def created_segments(monkeypatch):
    """The names of the shared-memory segments the loader creates."""
    names = []
    original = shared_memory.SharedMemory

    class Recording(original):
        def __init__(self, name=None, create=False, size=0, **kwargs):
            super().__init__(name=name, create=create, size=size, **kwargs)
            if create:
                names.append(self.name)

    monkeypatch.setattr(parallel_loader.shared_memory, "SharedMemory", Recording)
    return names


def _left_behind(names):
    return [n for n in names if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]


@pytest.mark.parametrize("workers", [2, 3])
def test_stream_is_the_jax_loaders_bitwise(tmp_path, workers):
    path = _build_store(tmp_path / "buf", n_eps=11)
    # each batch copied out and dropped at once, so that its segment recycles
    ours, theirs = ([{k: np.array(v) for k, v in b.items()} for b in loader(
        path, 2, BUCKETS, L, num_workers=workers, seed=4)]
        for loader in (parallel_batch_iterator, jax_parallel))
    assert len(ours) == len(theirs) >= 6
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k
    single = batch_iterator(TrajectoryDataset(path, batch_size=2, seed=4), 2, BUCKETS, L)
    assert _fingerprints(ours) == _fingerprints(single)


def test_segments_recycle_and_none_is_left(tmp_path, created_segments):
    path = _build_store(tmp_path / "buf", n_eps=12)
    seen = 0
    for batch in parallel_batch_iterator(path, 1, BUCKETS, L, num_workers=2, seed=7,
                                         segments_per_worker=2):
        seen += int(batch["valid_mask"].any())
        del batch
    assert seen == 12
    assert len(created_segments) == 4  # 12 batches through 4 segments
    gc.collect()
    assert _left_behind(created_segments) == []

    stream = parallel_batch_iterator(path, 1, BUCKETS, L, num_workers=2, seed=7)
    next(stream)
    stream.close()  # closed half read: the workers end, the segments go
    gc.collect()
    assert len(created_segments) == 8 and _left_behind(created_segments) == []


def test_a_workers_error_reaches_the_consumer(tmp_path, created_segments):
    path = _build_store(tmp_path / "buf", n_eps=6)
    # the parent's sizing probe decodes episode 0 only: episode 5 fails in a worker
    with TrajectoryStore(path, writable=True) as store:
        store.put(5, b"\x00garbage")
    with pytest.raises(RuntimeError, match="loader worker failed"):
        list(parallel_batch_iterator(path, 2, BUCKETS, L, num_workers=2, seed=0))
    gc.collect()
    assert _left_behind(created_segments) == []


def test_retained_batches_give_the_stall_diagnostic(tmp_path):
    path = _build_store(tmp_path / "buf", n_eps=12)
    retained = []
    stream = parallel_batch_iterator(path, 2, BUCKETS, L, num_workers=2, seed=0,
                                     segments_per_worker=1, stall_timeout_s=25.0)
    with pytest.raises(RuntimeError, match="free pool"):
        for batch in stream:
            retained.append(batch)  # never released: the pool runs dry
    assert retained


def test_cpu_tensors_keep_their_segment(tmp_path):
    """Tensors made from the first batch on the CPU, as the trainer makes
    them (a rank's rows, a TBPTT window, torch.from_numpy), hold its
    segment: the worker that shipped it reuses its other segment, and the
    tensors still hold the first batch's values at the end of the stream."""
    path = _build_store(tmp_path / "buf", n_eps=12)
    send, receive = device_transfer("cpu")
    assert receive is None
    stream = parallel_batch_iterator(path, 2, BUCKETS, L, num_workers=2, seed=1,
                                     segments_per_worker=2)
    first = next(stream)
    rows = {k: v[:1] for k, v in first.items()}
    tensors = send(next(split_tbptt(rows, 4)))
    kept = {k: v.clone() for k, v in tensors.items()}
    assert np.shares_memory(tensors["rgb"].numpy(), first["rgb"])
    del first, rows
    rest = 0
    for batch in stream:
        rest += 1
        del batch
        gc.collect()
    assert rest == 5
    for k, v in kept.items():
        assert torch.equal(tensors[k], v), k


@pytest.mark.parametrize("workers", [1, 2])
def test_a_ranks_rows_are_those_of_the_whole_batch(tmp_path, workers):
    """9 episodes in batches of 4: the last batch of the in-process loader,
    and of the parallel loader's first worker, holds one episode, so rank
    1's rows of it are all padding."""
    path = _build_store(tmp_path / "buf", n_eps=9)

    def stream(rows=None):
        return [{k: np.array(v) for k, v in b.items()} for b in parallel_batch_iterator(
            path, 4, BUCKETS, L, num_workers=workers, seed=3, rows=rows)]

    whole = stream()
    assert any(not b["valid_mask"][2:].any() for b in whole)
    for lo, hi in ((0, 2), (2, 4)):
        part = stream((lo, hi))
        assert len(part) == len(whole)
        for a, b in zip(part, whole):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k][lo:hi].shape, k
                assert a[k].tobytes() == b[k][lo:hi].tobytes(), k


@pytest.mark.parametrize("trainer", ["hierarchical_trainer", "robo_vln_trainer"])
def test_both_trainers_train_through_the_parallel_loader(tmp_path, trainer):
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
    from robo_vln_tpu_torch.utils.registry import get_trainer
    from tests.test_trainers import fill_buffer

    if trainer == "hierarchical_trainer":
        from tests.test_torch_trainer import tiny_opts

        opts, hw = tiny_opts(tmp_path, batch_size=2, **{"DAGGER.LOADER_WORKERS": 2}), 32
    else:
        from tests.test_torch_flat_trainer import SEQ2SEQ_PM, SIMPLE_PX, flat_opts

        opts, hw = flat_opts(tmp_path, batch_size=2, **SEQ2SEQ_PM,
                             **{"DAGGER.LOADER_WORKERS": 2}), SIMPLE_PX
    cfg = get_config(opts=opts)
    fill_buffer(cfg.DAGGER.LMDB_FEATURES_DIR, np.random.default_rng(6), n_eps=6, hw=hw)
    get_trainer(cfg.TRAINER_NAME)(cfg).train()
    assert [os.path.basename(c) for c in ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)] \
        == [f"ckpt.{cfg.DAGGER.EPOCHS}"]
    with open(os.path.join(cfg.TENSORBOARD_DIR, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [m["value"] for m in logged if "Loss" in m["tag"]]
    assert losses and all(np.isfinite(losses))
