"""The flat family's feature store (RoboVLNTrainer with
DAGGER.PRELOAD_TRUNK_FEATURES) against the JAX package's flat trainer, on
the CPU, float32.

The tiny CMA of tests/test_torch_flat_trainer.py at 32 px (one ResNet
block a stage), the JAX trainer's weights carried over, 16 train and 8 eval
episodes of tests/test_trainers's ``fill_buffer``:

1. each trainer featurizes its copy of the buffers: the port's twin holds
   what the JAX package's holds, the trunk features one float16 rounding
   apart (tests/test_torch_featurize.py's tolerance), no BERT row (the flat
   policies' instruction encoders train), every other key equal;
2. one epoch and its validation from the JAX package's twins: every logged
   loss within rtol 1e-4 of the JAX trainer's, and the parameters as in
   tests/test_torch_flat_trainer.py's epoch (also within 0.01 lr where the
   gradient stayed exactly 0), no trunk run;
3. the trainer's run end to end from features: the validation losses held
   to those from raw frames at float16 storage's tolerance (rtol 2e-2, atol
   2e-3); with SimpleCNN it warns and trains from raw frames, as JAX does.
"""

import logging
import math
import os

import jax
import numpy as np
import pytest
import torch

from robo_vln_tpu.data.trajectory_store import TrajectoryStore as JaxStore
from robo_vln_tpu.training.trainer import RoboVLNTrainer as JaxFlatTrainer
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.data import serialization
from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
from robo_vln_tpu_torch.models.encoders import resnet
from robo_vln_tpu_torch.training.trainer import RoboVLNTrainer
from robo_vln_tpu_torch.utils.weight_port import flat_state_dict, load_flat_weights
from tests.test_torch_featurize import FEATURE_ATOL, FEATURE_RTOL, LOSS_ATOL, LOSS_RTOL
from tests.test_torch_flat_trainer import _numpy_tree, flat_opts, jax_flat_config
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_trainer import GRAD_FLOOR, RecordingWriter
from tests.test_torch_trainer import LOSS_RTOL as EPOCH_RTOL
from tests.test_trainers import fill_buffer

HW = 32
CMA = {"MODEL.CMA.use": True, "TPU.PRECISION": "float32",
       "DAGGER.PRELOAD_TRUNK_FEATURES": True}


def _buffers(root, n_eps=16, n_eval=8):
    fill_buffer(str(root / "train_buf"), np.random.default_rng(0), n_eps=n_eps, hw=HW)
    fill_buffer(str(root / "eval_buf"), np.random.default_rng(1), n_eps=n_eval, hw=HW)


def _episodes(path):
    with TrajectoryStore(path) as store:
        return [serialization.unpackb_any(store.get_buffer(k)) for k in range(len(store))]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """(JAX trainer, port trainer with its weights, each one's featurized
    (train, eval) twins of its own copy of the same buffers, the port's
    root)."""
    jroot, proot = (tmp_path_factory.mktemp(n) for n in ("jax", "port"))
    _buffers(jroot)
    _buffers(proot)
    jt = JaxFlatTrainer(jax_flat_config(jroot, hw=HW, **CMA))
    jt._setup_policy()
    variables = _numpy_tree({"params": jt.state.params, **jt.extra_variables})
    jt.save_checkpoint = lambda name: None
    jdirs = jt._featurized_dirs()
    pt = RoboVLNTrainer(get_config(opts=flat_opts(proot, hw=HW, **CMA)))
    pt._setup_policy()
    load_flat_weights(pt.policy, variables)
    pt.save_checkpoint = lambda name: None
    pdirs = pt._featurized_dirs()
    return jt, pt, jdirs, pdirs, proot


def test_flat_store_matches_jax(trainers):
    jt, pt, jdirs, pdirs, _ = trainers
    for jdir, pdir in zip(jdirs, pdirs):
        assert pdir.endswith(".features") and jdir.endswith(".features")
        with JaxStore(jdir) as store:
            assert len(store) == len(_episodes(pdir))
        port, ref = _episodes(pdir), _episodes(jdir)
        for (p_obs, *p_rest), (j_obs, *j_rest) in zip(port, ref):
            assert p_obs.keys() == j_obs.keys()
            assert {"rgb", "depth", "instruction_embedding"}.isdisjoint(p_obs)
            for key in ("rgb_features", "depth_features"):
                assert p_obs[key].dtype == np.float16 and p_obs[key].shape == j_obs[key].shape
                np.testing.assert_allclose(p_obs[key].astype(np.float32),
                                           j_obs[key].astype(np.float32),
                                           rtol=FEATURE_RTOL, atol=FEATURE_ATOL, err_msg=key)
            for key in p_obs.keys() - {"rgb_features", "depth_features"}:
                np.testing.assert_array_equal(p_obs[key], j_obs[key], err_msg=key)
            for p, j in zip(p_rest, j_rest):
                np.testing.assert_array_equal(np.asarray(p), np.asarray(j))


def test_flat_feature_mode_epoch_matches_jax(trainers, monkeypatch):
    """One epoch and its validation from the JAX package's twins, both
    trainers on the same stores; the port runs no trunk."""
    jt, pt, (jtrain, jeval), _, _ = trainers
    jwriter = RecordingWriter()
    jt.train_epoch(jt._batches(jtrain, seed=0), 0, jwriter, 0)
    jt.val_epoch(jt._batches(jeval, seed=0), 0, jwriter, 0)

    trunk_calls = []
    for kind in (resnet.TVResNet50, resnet.GNResNetEncoder):
        forward = kind.forward
        monkeypatch.setattr(kind, "forward", lambda self, *a, _f=forward: (
            trunk_calls.append(type(self).__name__), _f(self, *a))[1])
    named = [(n, p) for g in pt.state.optimizer.param_groups for p in g["params"]
             for n, q in pt.policy.named_parameters() if q is p]
    steady, zero, step = {}, {}, pt.train_step

    def recording_step(state, hidden, window, lr):
        assert "rgb" not in window and "rgb_features" in window
        out = step(state, hidden, window, lr)
        for n, p in named:
            if p.grad is not None:
                steady[n] = (p.grad.abs() > GRAD_FLOOR) & steady.get(n, True)
                zero[n] = (p.grad == 0) & zero.get(n, True)
        return out

    monkeypatch.setattr(pt, "train_step", recording_step)
    pwriter = RecordingWriter()
    n_steps = pt.train_epoch(pt._batches(jtrain, seed=0), 0, pwriter, 0)
    pt.val_epoch(pt._batches(jeval, seed=0), 0, pwriter, 0)
    assert trunk_calls == []

    assert n_steps == 4 and len(pwriter.scalars) == len(jwriter.scalars)
    for (ptag, pval, pstep), (jtag, jval, jstep) in zip(pwriter.scalars, jwriter.scalars):
        assert (ptag, pstep) == (jtag, jstep)
        np.testing.assert_allclose(pval, jval, rtol=EPOCH_RTOL, err_msg=f"{ptag} {pstep}")
    want = flat_state_dict(_numpy_tree({"params": jt.state.params, **jt.extra_variables}))
    lr, checked = pt.config.DAGGER.LR, 0
    for name, p in named:
        if name not in want:  # the progress monitor, never called by the flax CMA here
            assert name.startswith("progress_monitor.") and name not in steady, name
            continue
        err = np.abs(p.detach().numpy() - want[name]) / lr
        assert err.max() <= 2 * n_steps, name
        # held tightly where the gradient stayed clear of 0, or at exactly 0
        # (dead trunk channels, GloVe rows of absent tokens)
        mask = (steady[name] | zero[name]).numpy()
        assert (err[mask] <= 0.01).all(), name
        checked += mask.sum()
    assert checked > 0.5 * sum(p.numel() for _, p in named)


def _val_losses(tb_dir):
    import json

    with open(os.path.join(tb_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r["tag"] == "Val Total Loss"]


def test_flat_run_from_features_matches_raw(tmp_path):
    """run's train from features against the same run from raw frames:
    the validation windows' losses (the first epoch's, whose weights both
    runs share up to the steps' float16 inputs) at float16 storage's
    tolerance; the twins sit beside the raw buffers."""
    _buffers(tmp_path, n_eps=8, n_eval=8)
    losses = {}
    for mode, features in (("raw", False), ("features", True)):
        opts = flat_opts(tmp_path, hw=HW, **{**CMA, "DAGGER.PRELOAD_TRUNK_FEATURES": features,
                                             "TENSORBOARD_DIR": str(tmp_path / f"tb_{mode}"),
                                             "CHECKPOINT_FOLDER": str(tmp_path / mode)})
        RoboVLNTrainer(get_config(opts=opts)).train()
        losses[mode] = _val_losses(str(tmp_path / f"tb_{mode}"))
    assert os.path.isdir(str(tmp_path / "train_buf.features"))
    assert os.path.isdir(str(tmp_path / "eval_buf.features"))
    assert len(losses["raw"]) == len(losses["features"]) > 0
    assert all(math.isfinite(v) for v in losses["features"])
    np.testing.assert_allclose(losses["features"], losses["raw"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_simple_cnn_trains_from_raw_frames(tmp_path, caplog):
    """DAGGER.PRELOAD_TRUNK_FEATURES, which robo_vln_trainer once refused,
    with SimpleCNN (seq2seq_robo_pm.yaml's encoders): a warning, then the
    raw buffers, as the JAX flat trainer does."""
    fill_buffer(str(tmp_path / "train_buf"), np.random.default_rng(0), n_eps=2, hw=36)
    opts = flat_opts(tmp_path, hw=36, batch_size=2, **{
        "DAGGER.PRELOAD_TRUNK_FEATURES": True, "MODEL.RGB_ENCODER.cnn_type": "SimpleRGBCNN",
        "MODEL.DEPTH_ENCODER.cnn_type": "SimpleDepthCNN"})
    trainer = RoboVLNTrainer(get_config(opts=opts))
    with caplog.at_level(logging.WARNING):
        trainer.train()
    assert "requires the ResNet encoder types" in caplog.text
    assert not os.path.exists(str(tmp_path / "train_buf.features"))
    assert os.path.isdir(os.path.join(trainer.config.CHECKPOINT_FOLDER, "ckpt.1"))
