"""``python -m robo_vln_tpu_torch.run``'s train over two gloo ranks on the CPU
(TPU.MESH_SHAPE [2, 1], DEVICE cpu) against one process on the global
batch.

The hierarchical trainer on tests/test_torch_trainer.tiny_opts' model,
float32, dropout 0: 6 train episodes (a global batch of 4, so the tail
batch's second rank holds nothing but padding) and 3 eval episodes, two
epochs.  One process at DAGGER.BATCH_SIZE 4 trains both in one run; two
ranks at BATCH_SIZE 2 train one a run (DAGGER.MAX_EPOCHS_PER_RUN 1,
DAGGER.RESUME), so the second run's ranks each load ckpt.2.  Both end each
epoch with the same checkpoint: every parameter within 1e-5, both Adam
states within 1e-5, the same counters and metadata; every logged loss
within 1e-5 relative, logged once.  Rank 0 alone writes: one TensorBoard
event file a run, one metrics file with the one-process run's lines, no
stray checkpoint file.  A rank that fails fails the run.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from robo_vln_tpu_torch.run import run_exp
from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_trainer import tiny_opts
from tests.test_trainers import fill_buffer

TOL = 1e-5


def _opts(root, run, batch_size, mesh, **extra):
    return tiny_opts(root, batch_size=batch_size, **{
        "TPU.MESH_SHAPE": mesh, "TPU.PRECISION": "float32",
        "MODEL.VISUAL_LING_ATTN.dropout": 0.0, "DAGGER.EPOCHS": 2,
        "CHECKPOINT_FOLDER": str(root / run / "ckpts"),
        "TENSORBOARD_DIR": str(root / run / "tb"), **extra})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_trainer")
    fill_buffer(str(root / "train_buf"), np.random.default_rng(6), n_eps=6, hw=32)
    fill_buffer(str(root / "eval_buf"), np.random.default_rng(7), n_eps=3, hw=32)
    run_exp(None, "train", _opts(root, "one", 4, [-1, 1]))
    for _ in range(2):  # an epoch a run, the second resuming from ckpt.2
        run_exp(None, "train", _opts(root, "two", 2, [2, 1], **{
            "DAGGER.MAX_EPOCHS_PER_RUN": 1, "DAGGER.RESUME": True}))
    yield root
    shutil.rmtree(root)  # four checkpoints of the tiny HCM's trunks


def _state(root, run, name):
    ckpts = ckpt_lib.list_checkpoints(str(root / run / "ckpts"))
    assert [os.path.basename(c) for c in ckpts] == ["ckpt.2", "ckpt.3"]
    path = str(root / run / "ckpts" / name)
    return (torch.load(os.path.join(path, ckpt_lib.TRAIN_STATE), weights_only=True),
            ckpt_lib.load_metadata(path))


def _close(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _close(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0, msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name,steps", [("ckpt.2", 4), ("ckpt.3", 8)])
def test_two_ranks_end_with_the_one_process_checkpoint(runs, name, steps):
    (one, meta_one), (two, meta_two) = _state(runs, "one", name), _state(runs, "two", name)
    assert one.keys() == two.keys()
    for key in one:
        _close(two[key], one[key], key)
    assert not any(k.startswith("module.") for k in two["high_level_state_dict"])
    for meta in (meta_one, meta_two):
        meta.pop("config")
    assert meta_two == meta_one and meta_one["train_steps"] == steps


def _logged(root, run):
    with open(root / run / "tb" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_rank_zero_alone_logs_and_writes(runs):
    one, two = _logged(runs, "one"), _logged(runs, "two")
    assert [(m["tag"], m["step"]) for m in two] == [(m["tag"], m["step"]) for m in one]
    for a, b in zip(two, one):
        np.testing.assert_allclose(a["value"], b["value"], rtol=TOL, atol=TOL, err_msg=b["tag"])
    events = [f for f in os.listdir(runs / "two" / "tb") if f.startswith("events.")]
    assert len(events) <= 2  # one a run, where TensorBoard imports
    for name in ("ckpt.2", "ckpt.3"):
        files = sorted(os.listdir(runs / "two" / "ckpts" / name))
        assert files == sorted(os.listdir(runs / "one" / "ckpts" / name))


def test_a_failing_rank_fails_the_run(tmp_path):
    """A corrupt episode in the buffer: the ranks' decode raises, the other
    rank is ended, and run_exp raises."""
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore

    fill_buffer(str(tmp_path / "train_buf"), np.random.default_rng(6), n_eps=4, hw=32)
    with TrajectoryStore(str(tmp_path / "train_buf"), writable=True) as store:
        store.put(2, b"\x00garbage")
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        run_exp(None, "train", _opts(tmp_path, "bad", 2, [2, 1]))
    assert not (tmp_path / "bad" / "ckpts" / "ckpt.2").exists()
