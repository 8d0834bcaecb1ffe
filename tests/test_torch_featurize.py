"""The port's trunk-feature store (training/featurize.py) and the
hierarchical trainer's feature mode (DAGGER.PRELOAD_TRUNK_FEATURES) against
the JAX package's.

The tiny HCM of tests/test_featurize.py (32 px frames, one ResNet block a
stage, BERT 1x16), float32, both policies' trunks synced; the JAX trainer's
weights carried over by ``load_hierarchical_weights``.

1. The port's store built from a raw buffer matches the JAX package's
   store built from the same buffer: each trunk feature and BERT row within
   FEATURE_RTOL / FEATURE_ATOL (float16 storage: one float16 rounding of
   float32 values that differ by summation order), every other key and the
   actions bitwise.
2. A cache that the JAX package wrote is stale for the port (another
   fingerprint) and is rebuilt, never reused.
3. Feature-mode losses match raw-frame losses (tests/test_featurize.py's
   tolerances), and a feature batch carries no raw frames.
4. A changed trunk weight or MAX_INSTRUCTION_LEN rebuilds; a grown buffer
   appends only its tail; MODEL.BERT.trainable with the store raises; trunks
   that differ between the policies train from raw frames, with a warning;
   the trainer runs an epoch from features end to end.
"""

import json
import logging
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.training.featurize import ensure_featurized as jax_ensure_featurized
from robo_vln_tpu_torch.data import serialization
from robo_vln_tpu_torch.data.loader import write_episode
from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
from robo_vln_tpu_torch.training import featurize, steps
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
from robo_vln_tpu_torch.utils.weight_port import load_hierarchical_weights
from tests.test_featurize import _synced_hier_trainer
from tests.test_torch_trainer import HW, port_config
from tests.test_trainers import fill_buffer
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FEATURE_RTOL, FEATURE_ATOL = 2e-3, 1e-4  # one float16 rounding apart
LOSS_RTOL, LOSS_ATOL = 2e-2, 2e-3  # tests/test_featurize.py: float16 storage
N_EPS = 3


def _episodes(path):
    with TrajectoryStore(path) as store:
        return [serialization.unpackb_any(store.get_buffer(k)) for k in range(len(store))]


def _meta(path):
    with open(os.path.join(path, featurize.META)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """The JAX package's feature store of a raw buffer, and its weights."""
    tmp = tmp_path_factory.mktemp("jax_featurize")
    cfg, jt = _synced_hier_trainer(tmp / "jax")
    raw = str(tmp / "raw")
    fill_buffer(raw, np.random.default_rng(0), n_eps=N_EPS, hw=HW)
    params = jax.device_get(jt.state.high.params)
    out = jax_ensure_featurized(cfg, jnp.float32, params, jt._high_extra, raw)
    to_np = lambda tree: jax.tree.map(np.asarray, jax.device_get(tree))  # noqa: E731
    return SimpleNamespace(
        raw=raw, store=out, max_len=cfg.DAGGER.MAX_INSTRUCTION_LEN,
        high_vars=to_np({"params": jt.state.high.params, **jt._high_extra}),
        low_vars=to_np({"params": jt.state.low.params, **jt._low_extra}))


def _trainer(tmp_path, weights=None, **extra):
    cfg = port_config(tmp_path, batch_size=4, **{
        "TPU.PRECISION": "float32", "TPU.SYNC_FROZEN_TRUNKS_ON_INIT": True,
        "MODEL.INSTRUCTION_ENCODER.is_bert": True, "MODEL.VISUAL_LING_ATTN.dropout": 0.0,
        **extra})
    trainer = HierarchicalTrainer(cfg)
    trainer._setup_policy()
    if weights is not None:
        load_hierarchical_weights(trainer.high, trainer.low, weights.high_vars,
                                  weights.low_vars)
    return trainer


def _copy_raw(jax_store, dst, with_cache=False):
    shutil.copytree(jax_store.raw, dst)
    if with_cache:
        shutil.copytree(jax_store.store, str(dst) + ".features")
    return str(dst)


@pytest.fixture
def written(monkeypatch):
    """Each featurize_buffer call's start_key and counts."""
    calls = []
    original = featurize.featurize_buffer

    def record(high, raw_dir, out_dir, start_key=0, **kwargs):
        out = original(high, raw_dir, out_dir, start_key=start_key, **kwargs)
        calls.append((start_key, out["episodes"]))
        return out

    monkeypatch.setattr(featurize, "featurize_buffer", record)
    return calls


def test_store_matches_jax(tmp_path, jax_store, written):
    trainer = _trainer(tmp_path, jax_store)
    raw = _copy_raw(jax_store, tmp_path / "raw")
    out = featurize.ensure_featurized(trainer.config, trainer.high, raw)
    assert out == raw + ".features" and written == [(0, N_EPS)]
    assert _meta(out) == {"fingerprint": featurize.trunk_fingerprint(trainer.high),
                          "episodes": N_EPS, "source": raw,
                          "max_instruction_len": jax_store.max_len}
    with TrajectoryStore(out) as store:
        assert all(serialization.is_flat(store.get_buffer(k)) for k in range(N_EPS))
    port, ref = _episodes(out), _episodes(jax_store.store)
    assert len(port) == len(ref) == N_EPS
    for (p_obs, *p_rest), (j_obs, *j_rest) in zip(port, ref):
        assert p_obs.keys() == j_obs.keys()
        assert {"rgb", "depth"}.isdisjoint(p_obs)
        for key in ("rgb_features", "depth_features", "instruction_embedding"):
            assert p_obs[key].dtype == np.float16 and p_obs[key].shape == j_obs[key].shape, key
            np.testing.assert_allclose(p_obs[key].astype(np.float32),
                                       j_obs[key].astype(np.float32),
                                       rtol=FEATURE_RTOL, atol=FEATURE_ATOL, err_msg=key)
        assert p_obs["instruction_embedding"].shape == (jax_store.max_len, 16)
        for key in p_obs.keys() - {"rgb_features", "depth_features", "instruction_embedding"}:
            np.testing.assert_array_equal(p_obs[key], j_obs[key], err_msg=key)
        for p, j in zip(p_rest, j_rest):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(j))


def test_jax_cache_is_rebuilt(tmp_path, jax_store, written):
    trainer = _trainer(tmp_path, jax_store)
    raw = _copy_raw(jax_store, tmp_path / "raw", with_cache=True)
    stale = _meta(raw + ".features")
    fingerprint = featurize.trunk_fingerprint(trainer.high)
    assert stale["episodes"] == N_EPS and stale["fingerprint"] != fingerprint
    featurize.ensure_featurized(trainer.config, trainer.high, raw)
    assert written == [(0, N_EPS)]
    assert _meta(raw + ".features")["fingerprint"] == fingerprint
    fresh = _copy_raw(jax_store, tmp_path / "fresh")
    featurize.ensure_featurized(trainer.config, trainer.high, fresh)
    with TrajectoryStore(raw + ".features") as a, TrajectoryStore(fresh + ".features") as b:
        assert [a.get(k) for k in range(N_EPS)] == [b.get(k) for k in range(N_EPS)]


def test_feature_losses_match_raw(tmp_path):
    trainer = _trainer(tmp_path)
    fill_buffer(trainer.features_dir, np.random.default_rng(1), n_eps=N_EPS, hw=HW)
    feat_dir, eval_dir = trainer._featurized_dirs()
    assert feat_dir == trainer.features_dir + ".features" and eval_dir == trainer.eval_dir
    raw_batch = next(iter(trainer._batches(trainer.features_dir, seed=0)))
    feat_batch = next(iter(trainer._batches(feat_dir, seed=0)))
    assert "rgb" not in feat_batch and "depth" not in feat_batch
    assert feat_batch["rgb_features"].dtype == np.float16
    emb = feat_batch["instruction_embedding"]
    assert emb.dtype == np.float16 and emb.shape[:2] == feat_batch["instruction"].shape
    np.testing.assert_array_equal(raw_batch["corrected_actions"],
                                  feat_batch["corrected_actions"])
    assert trainer.trunk_fn is not None

    def losses(batch):
        window = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        hh, lh = trainer._initial_hidden()
        with torch.no_grad():
            out = steps._hier_losses(trainer.high.eval(), trainer.low.eval(), window, hh, lh,
                                     trunk_fn=trainer.trunk_fn)
        return np.array([float(x) for x in out[:3]])

    np.testing.assert_allclose(losses(feat_batch), losses(raw_batch), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


@pytest.mark.parametrize("change", ["trunk_weight", "max_instruction_len"])
def test_stale_cache_rebuilds(tmp_path, written, change):
    trainer = _trainer(tmp_path)
    fill_buffer(trainer.features_dir, np.random.default_rng(2), n_eps=2, hw=HW)
    out = featurize.ensure_featurized(trainer.config, trainer.high, trainer.features_dir)
    first = _meta(out)
    featurize.ensure_featurized(trainer.config, trainer.high, trainer.features_dir)
    assert written == [(0, 2)] and _meta(out) == first  # reused
    config = trainer.config
    if change == "trunk_weight":
        with torch.no_grad():
            trainer.high.rgb_encoder.cnn.conv1.weight.add_(1.0)
    else:
        config = config.clone().defrost()
        config.DAGGER.MAX_INSTRUCTION_LEN += 7
        config.freeze()
    featurize.ensure_featurized(config, trainer.high, trainer.features_dir)
    assert written == [(0, 2), (0, 2)]
    meta = _meta(out)
    assert meta["max_instruction_len"] == config.DAGGER.MAX_INSTRUCTION_LEN
    assert (meta["fingerprint"] != first["fingerprint"]) == (change == "trunk_weight")
    obs = _episodes(out)[0][0]
    assert obs["instruction_embedding"].shape[0] == config.DAGGER.MAX_INSTRUCTION_LEN


def test_grown_buffer_appends_its_tail(tmp_path, written):
    trainer = _trainer(tmp_path)
    buf = trainer.features_dir
    rng = np.random.default_rng(3)
    fill_buffer(buf, rng, n_eps=2, hw=HW)
    out = featurize.ensure_featurized(trainer.config, trainer.high, buf)
    with TrajectoryStore(out) as store:
        before = [store.get(k) for k in range(2)]
    with TrajectoryStore(buf, writable=True) as store:
        for key in (2, 3):
            t = 6
            obs = {"rgb": rng.integers(0, 255, (t, HW, HW, 3)).astype(np.uint8),
                   "depth": rng.random((t, HW, HW, 1)).astype(np.float16),
                   "vln_oracle_action_sensor": rng.integers(1, 4, (t, 1)).astype(np.float64),
                   "instruction": np.tile(rng.integers(1, 50, (1, 10)).astype(np.float64),
                                          (t, 1))}
            write_episode(store, key, obs, rng.random((t, 2)), rng.random((t, 2)), [t - 1] * t)
    assert featurize.ensure_featurized(trainer.config, trainer.high, buf) == out
    assert written == [(0, 2), (2, 2)] and _meta(out)["episodes"] == 4
    with TrajectoryStore(out) as store:
        assert len(store) == 4 and [store.get(k) for k in range(2)] == before


def test_trainable_bert_with_the_store_raises(tmp_path):
    cfg = port_config(tmp_path, **{"MODEL.BERT.trainable": True,
                                   "DAGGER.PRELOAD_TRUNK_FEATURES": True})
    fill_buffer(cfg.DAGGER.LMDB_FEATURES_DIR, np.random.default_rng(4), n_eps=2, hw=HW)
    with pytest.raises(ValueError, match="MODEL.BERT.trainable"):
        HierarchicalTrainer(cfg).train()
    assert not (tmp_path / "ckpts").exists() and not (tmp_path / "tb").exists()
    assert not os.path.exists(cfg.DAGGER.LMDB_FEATURES_DIR + ".features")


def test_differing_trunks_train_from_raw_frames(tmp_path, caplog):
    trainer = _trainer(tmp_path, **{"TPU.SYNC_FROZEN_TRUNKS_ON_INIT": False})
    fill_buffer(trainer.features_dir, np.random.default_rng(5), n_eps=2, hw=HW)
    with caplog.at_level(logging.WARNING, logger="robo_vln_tpu_torch"):
        dirs = trainer._featurized_dirs()
    assert dirs == (trainer.features_dir, trainer.eval_dir)
    assert "high/low trunk weights differ" in caplog.text
    assert not os.path.exists(trainer.features_dir + ".features")


def test_trainer_epoch_from_features(tmp_path, monkeypatch):
    seen = []
    original = steps._hier_losses

    def record(high, low, batch, *args, **kwargs):
        seen.append(sorted(batch))
        return original(high, low, batch, *args, **kwargs)

    monkeypatch.setattr(steps, "_hier_losses", record)
    cfg = port_config(tmp_path, batch_size=2, **{
        "DAGGER.PRELOAD_TRUNK_FEATURES": True, "TPU.SYNC_FROZEN_TRUNKS_ON_INIT": True,
        "MODEL.INSTRUCTION_ENCODER.is_bert": True})
    fill_buffer(cfg.DAGGER.LMDB_FEATURES_DIR, np.random.default_rng(6), n_eps=4, hw=HW)
    fill_buffer(cfg.DAGGER.LMDB_EVAL_DIR, np.random.default_rng(7), n_eps=2, hw=HW)
    HierarchicalTrainer(cfg).train()
    for buf, n in ((cfg.DAGGER.LMDB_FEATURES_DIR, 4), (cfg.DAGGER.LMDB_EVAL_DIR, 2)):
        assert _meta(buf + ".features")["episodes"] == n
    assert seen and all("rgb_features" in keys and "rgb" not in keys for keys in seen)
    assert os.path.isdir(os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.1"))
    with open(os.path.join(cfg.TENSORBOARD_DIR, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    train = [m["value"] for m in logged if m["tag"] == "Train High Level Action Loss"]
    val = [m["value"] for m in logged if m["tag"] == "Val High Level Loss"]
    assert train and val and np.isfinite(train + val).all()
