"""The port's hierarchical trainer (training/hierarchical_trainer.py, the
config it reads and ``python -m robo_vln_tpu_torch.run``) against the JAX
package's.

Shapes are those of tests/test_trainers.py (``tiny_config`` /
``fill_buffer``): 32 px frames, one ResNet block a stage, BERT 1x16, an LSTM
of 32, TBPTT windows of 4 in buckets of 4 and 8.  The JAX trainer runs on the
tests' virtual mesh of 8 devices with ``DAGGER.BATCH_SIZE`` 1 a device, so
its global batch is 8; the port runs on the CPU with ``DAGGER.BATCH_SIZE`` 8.

1. Config: the port's ``get_config`` on its yaml copies equals the JAX
   package's on its yamls for every key the port holds; the copies are
   byte-identical.
2. Loop parity (no compile): both ``train_epoch`` loops, their steps
   replaced by recorders, make the same calls: bitwise-equal windows, the
   same first-window hidden resets, the same ``lr_high`` (CyclicLR stepped
   per outer batch) and ``lr_low``, the same logging tags and counters, and
   the same final ``scheduler_step`` and ``train_steps``.
3. Numeric parity over one epoch, float32, dropout 0, the JAX trainer's
   weights carried over: every logged loss within rtol 1e-4; the final
   trainable parameters, in units of each level's largest learning rate,
   within 0.01 where the port's gradient stayed above 1e-5 at every step and
   within 2 a step elsewhere (the scheme of tests/test_torch_train_step.py).
4. Exact resume, port only, dropout on: a run split in two processes'
   worth of trainers ends bitwise where an uninterrupted run ends (weights,
   optimizer state, counters, every logged value); a third run is a no-op.
5. Options the port does not have yet raise before any work (the flat
   family's feature store under ``robo_vln_trainer`` among them), and so
   do keys of the JAX package the port does not read, set past their JAX
   default; the flat family's keys, refused until it was ported, are read.
6. The entry point trains on the CPU when asked and raises without CUDA.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from robo_vln_tpu.config.default import _C as jax_defaults
from robo_vln_tpu.config.default import get_config as jax_get_config
from robo_vln_tpu.config.tree import ConfigTree as JaxConfigTree
from robo_vln_tpu.models import build_hierarchical_policies as jax_build
from robo_vln_tpu.training.hierarchical_trainer import HierarchicalTrainer as JaxTrainer
from robo_vln_tpu_torch.config import get_config, jax_only
from robo_vln_tpu_torch.config.default import _C as port_defaults
from robo_vln_tpu_torch.config.tree import ConfigTree
from robo_vln_tpu_torch.models import build_hierarchical_policies
from robo_vln_tpu_torch.run import run_exp
from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
from robo_vln_tpu_torch.training import trainable_mask
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
from robo_vln_tpu_torch.utils.registry import get_trainer
from robo_vln_tpu_torch.utils.weight_port import (
    high_level_state_dict,
    load_hierarchical_weights,
    low_level_state_dict,
)
from tests.test_trainers import fill_buffer, tiny_config
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PORT_CONFIGS = REPO / "robo_vln_tpu_torch" / "config" / "configs"
JAX_CONFIGS = REPO / "robo_vln_tpu" / "config" / "configs"
LOSS_RTOL = 1e-4
GRAD_FLOOR = 1e-5  # |g| above which Adam's step direction is not noise
HW = 32

# tests/test_trainers.tiny_config's model, for the port
TINY_MODEL = {
    "DEPTH_ENCODER.blocks": [1, 1, 1, 1], "RGB_ENCODER.blocks": [1, 1, 1, 1],
    "STATE_ENCODER.hidden_size": 32, "RGB_ENCODER.output_size": 16,
    "DEPTH_ENCODER.output_size": 8, "BERT.num_layers": 1, "BERT.hidden_size": 16,
    "BERT.num_heads": 2, "BERT.intermediate_size": 32, "BERT.vocab_size": 60,
    "VISUAL_LING_ATTN.ins_in_features": 16, "VISUAL_LING_ATTN.d_model": 16,
    "VISUAL_LING_ATTN.d_ff": 32, "VISUAL_LING_ATTN.h": 2,
}
# a CyclicLR that moves every batch
CYCLIC = {"DAGGER.CYCLIC_BASE_LR": 1e-5, "DAGGER.CYCLIC_MAX_LR": 1e-4,
          "DAGGER.CYCLIC_STEP_SIZE_UP": 2, "DAGGER.CYCLIC_STEP_SIZE_DOWN": 3}


def tiny_opts(tmp_path, batch_size=8, **extra):
    """The port's trailing options for tiny_config's run: its loop, its
    model, its sensors, CPU."""
    opts = {
        "DEVICE": "cpu", "TRAINER_NAME": "hierarchical_trainer",
        "DAGGER.BATCH_SIZE": batch_size, "DAGGER.EPOCHS": 1, "DAGGER.tbptt_steps": 4,
        "DAGGER.EPISODE_LEN_BUCKETS": [4, 8], "DAGGER.MAX_INSTRUCTION_LEN": 12,
        "DAGGER.PRELOAD_LMDB_FEATURES": True,
        "DAGGER.LMDB_FEATURES_DIR": str(tmp_path / "train_buf"),
        "DAGGER.LMDB_EVAL_DIR": str(tmp_path / "eval_buf"),
        "CHECKPOINT_FOLDER": str(tmp_path / "ckpts"),
        "TENSORBOARD_DIR": str(tmp_path / "tb"), "LOG_FILE": str(tmp_path / "train.log"),
        "MODEL.INSTRUCTION_ENCODER.vocab_size": 60,
        "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings": False,
        "MODEL.INSTRUCTION_ENCODER.hidden_size": 16,
        **{f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}": HW
           for s in ("RGB", "DEPTH") for d in ("WIDTH", "HEIGHT")},
        **{f"MODEL.{k}": v for k, v in TINY_MODEL.items()},
        **extra,
    }
    return [x for kv in opts.items() for x in kv]


def port_config(tmp_path, **extra):
    return get_config(opts=tiny_opts(tmp_path, **extra))


def jax_config(tmp_path, **extra):
    cfg = tiny_config(tmp_path, trainer="hierarchical_trainer", batch_size=1, hw=HW)
    for key, value in extra.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, value)
    cfg.freeze()
    return cfg


def buffers(tmp_path, n_eps=16, n_eval=8):
    fill_buffer(str(tmp_path / "train_buf"), np.random.default_rng(0), n_eps=n_eps, hw=HW)
    fill_buffer(str(tmp_path / "eval_buf"), np.random.default_rng(1), n_eps=n_eval, hw=HW)


class RecordingWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


# -- 1. config -------------------------------------------------------------------

def _port_keys(tree, prefix=""):
    """(dotted key, value) of every leaf of a config tree of either package."""
    for k, v in tree.items():
        if isinstance(v, (ConfigTree, JaxConfigTree)):
            yield from _port_keys(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _lookup(tree, key):
    for part in key.split("."):
        tree = getattr(tree, part)
    return tree


@pytest.mark.parametrize("yaml", [None, "hierarchical_cma.yaml", "robovln_data_train.yaml",
                                  "robovln_data_val.yaml", "cma_robo.yaml", "seq2seq_robo.yaml",
                                  "seq2seq_robo_pm.yaml"])
def test_config_matches_jax(yaml, monkeypatch):
    monkeypatch.chdir(REPO)  # the JAX yamls name their task config from the repo root
    opts = ["DAGGER.EPOCHS", "3", "MODEL.BERT.num_layers", "2", "DAGGER.EPISODE_LEN_BUCKETS",
            "[50, 100]"]
    port = get_config(str(PORT_CONFIGS / yaml) if yaml else None, opts)
    ref = jax_get_config(str(JAX_CONFIGS / yaml) if yaml else None, opts)
    port_only = {"DEVICE", "MODEL.DEPTH_ENCODER.input_size"}
    keys = dict(_port_keys(port))
    assert len(keys) > 100
    for key, value in keys.items():
        if key in port_only:
            continue
        assert value == _lookup(ref, key), key
    assert port.TASK_CONFIG.to_dict() == ref.TASK_CONFIG.to_dict()
    assert port.DEVICE == "cuda"
    assert port.MODEL.DEPTH_ENCODER.input_size == ref.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH


def test_config_files_are_copies():
    for name in ("hierarchical_cma.yaml", "robo_vln_task.yaml", "robovln_data_train.yaml",
                 "robovln_data_val.yaml", "cma_robo.yaml", "seq2seq_robo.yaml",
                 "seq2seq_robo_pm.yaml"):
        assert (PORT_CONFIGS / name).read_bytes() == (JAX_CONFIGS / name).read_bytes()
    assert (REPO / "robo_vln_tpu_torch/config/task.py").read_text().split('"""', 2)[2] == \
        (REPO / "robo_vln_tpu/config/task.py").read_text().split('"""', 2)[2]


def test_depth_input_size_follows_the_task():
    sensor = "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR."
    cfg = get_config(opts=[sensor + "WIDTH", 64, sensor + "HEIGHT", 64])
    assert cfg.MODEL.DEPTH_ENCODER.input_size == 64
    with pytest.raises(ValueError, match="disagrees"):
        get_config(opts=["MODEL.DEPTH_ENCODER.input_size", 128])
    with pytest.raises(ValueError, match="square"):
        get_config(opts=[sensor + "WIDTH", 64])


# -- 2. loop parity ----------------------------------------------------------------

def test_train_epoch_makes_the_jax_loops_calls(tmp_path):
    buffers(tmp_path, n_eps=21)  # three batches, the last one padded
    jt = JaxTrainer(jax_config(tmp_path, **CYCLIC))
    assert jt.global_batch == 8
    jt.high, jt.low = jax_build(jt.config.MODEL)
    pt = HierarchicalTrainer(port_config(tmp_path, **CYCLIC))
    pt.high, pt.low = build_hierarchical_policies(pt.config.MODEL)

    runs = {}
    for name, trainer, to_numpy, bump, zero in (
            ("jax", jt, np.asarray, lambda h: h + 1, 0.0),
            ("port", pt, lambda t: t.numpy(), lambda h: h + 1, torch.tensor(0.0))):
        calls, saved, writer = [], [], RecordingWriter()
        metrics = {k: zero for k in ("high_level_loss", "low_level_action_loss",
                                     "low_level_stop_loss", "low_level_total_loss")}

        def step(state, hh, lh, window, lr_high, lr_low, calls=calls, to_numpy=to_numpy,
                 bump=bump, metrics=metrics):
            calls.append({"window": {k: to_numpy(v) for k, v in window.items()},
                          "hidden": (float(to_numpy(hh).max()), float(to_numpy(lh).max())),
                          "lr": (lr_high, lr_low)})
            return state, bump(hh), bump(lh), metrics

        trainer.train_step = step
        trainer.save_checkpoint = saved.append
        trainer._scheduler_step = 4
        steps = trainer.train_epoch(trainer._batches(trainer.features_dir, seed=1), 1, writer, 10)
        runs[name] = calls, saved, writer.scalars, steps, trainer._scheduler_step

    (jcalls, jsaved, jlog, jsteps, jsched), (pcalls, psaved, plog, psteps, psched) = (
        runs["jax"], runs["port"])
    assert len(pcalls) == len(jcalls) == 6
    for p, j in zip(pcalls, jcalls):
        assert p["window"].keys() == j["window"].keys()
        for k, v in j["window"].items():
            assert p["window"][k].dtype == v.dtype and np.array_equal(p["window"][k], v), k
        assert p["hidden"] == j["hidden"]
        assert p["lr"] == j["lr"]
    assert [c["hidden"][0] for c in pcalls] == [0.0, 1.0, 0.0, 1.0, 0.0, 1.0]
    assert len({c["lr"][0] for c in pcalls}) == 3  # one learning rate a batch
    assert [(tag, step) for tag, _, step in plog] == [(tag, step) for tag, _, step in jlog]
    assert (psteps, psched, psaved) == (jsteps, jsched, jsaved) == (16, 7, ["ckpt.2"])


# -- 3. numeric parity over one epoch --------------------------------------------------

def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_one_epoch_matches_jax(tmp_path):
    buffers(tmp_path)
    common = {**CYCLIC, "TPU.PRECISION": "float32", "TPU.SYNC_FROZEN_TRUNKS_ON_INIT": True,
              "MODEL.VISUAL_LING_ATTN.dropout": 0.0}
    jt = JaxTrainer(jax_config(tmp_path, **common))
    jt._setup_policy()
    high_vars = _numpy_tree({"params": jt.state.high.params, **jt._high_extra})
    low_vars = _numpy_tree({"params": jt.state.low.params, **jt._low_extra})
    jwriter = RecordingWriter()
    jt.save_checkpoint = lambda name: None
    jt.train_epoch(jt._batches(jt.features_dir, seed=0), 0, jwriter, 0)

    pt = HierarchicalTrainer(port_config(tmp_path, **common))
    pt._setup_policy()
    load_hierarchical_weights(pt.high, pt.low, high_vars, low_vars)
    assert pt.trunk_fn is not None
    pt.save_checkpoint = lambda name: None
    named = [(level, n, p) for level, pol in (("high", pt.high), ("low", pt.low))
             for mask in (trainable_mask(pol),) for n, p in pol.named_parameters() if mask[n]]
    steady, lrs, step = {}, {"high": [], "low": []}, pt.train_step

    def recording_step(state, hh, lh, window, lr_high, lr_low):
        out = step(state, hh, lh, window, lr_high, lr_low)
        lrs["high"].append(lr_high)
        lrs["low"].append(lr_low)
        for level, n, p in named:
            if p.grad is not None:
                big = p.grad.abs() > GRAD_FLOOR
                steady[level, n] = big & steady.get((level, n), True)
        return out

    pt.train_step = recording_step
    pwriter = RecordingWriter()
    pt.train_epoch(pt._batches(pt.features_dir, seed=0), 0, pwriter, 0)

    assert len(pwriter.scalars) == len(jwriter.scalars) == 4 * 4
    for (ptag, pval, pstep), (jtag, jval, jstep) in zip(pwriter.scalars, jwriter.scalars):
        assert (ptag, pstep) == (jtag, jstep)
        np.testing.assert_allclose(pval, jval, rtol=LOSS_RTOL, err_msg=f"{ptag} {pstep}")

    want = {"high": high_level_state_dict(_numpy_tree({"params": jt.state.high.params,
                                                       **jt._high_extra})),
            "low": low_level_state_dict(_numpy_tree({"params": jt.state.low.params,
                                                     **jt._low_extra}))}
    n_steps = len(lrs["high"])
    checked = 0
    for level, name, p in named:
        if name.startswith("progress_monitor."):
            continue  # never created by the flax policies, never called
        unit = max(lrs[level])
        err = np.abs(p.detach().numpy() - want[level][name]) / unit
        assert err.max() <= 2 * n_steps, f"{level} {name}"
        mask = steady[level, name].numpy()
        assert (err[mask] <= 0.01).all(), f"{level} {name}"
        checked += mask.sum()
    assert checked > 0.5 * sum(p.numel() for _, n, p in named)


# -- 4. exact resume ----------------------------------------------------------------

def _final_state(folder):
    last = ckpt_lib.list_checkpoints(folder)[-1]
    state = torch.load(os.path.join(last, ckpt_lib.TRAIN_STATE), weights_only=True)
    meta = ckpt_lib.load_metadata(last)
    return state, {k: v for k, v in meta.items() if k != "config"}


def _assert_bitwise(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _logged(tb_dir):
    with open(os.path.join(tb_dir, "metrics.jsonl")) as f:
        return [(m["tag"], m["value"], m["step"]) for m in map(json.loads, f)]


def test_resume_matches_uninterrupted_run(tmp_path):
    """DAGGER.RESUME with MAX_EPOCHS_PER_RUN 1: two trainers, each a fresh
    process's worth of state, end bitwise where one uninterrupted run ends,
    with dropout live (its masks are keyed by the restored step)."""
    buffers(tmp_path, n_eps=4, n_eval=2)

    def cfg(run, **extra):
        return port_config(tmp_path, batch_size=2, **CYCLIC, **{
            "DAGGER.EPOCHS": 2, "CHECKPOINT_FOLDER": str(tmp_path / run / "ckpts"),
            "TENSORBOARD_DIR": str(tmp_path / run / "tb"), **extra})

    a = cfg("a")
    assert a.MODEL.VISUAL_LING_ATTN.dropout > 0
    HierarchicalTrainer(a).train()
    b = cfg("b", **{"DAGGER.RESUME": True, "DAGGER.MAX_EPOCHS_PER_RUN": 1})
    HierarchicalTrainer(b).train()
    assert len(ckpt_lib.list_checkpoints(b.CHECKPOINT_FOLDER)) == 1
    HierarchicalTrainer(b).train()
    ckpts = ckpt_lib.list_checkpoints(b.CHECKPOINT_FOLDER)
    assert [os.path.basename(c) for c in ckpts] == ["ckpt.2", "ckpt.3"]

    (state_a, meta_a), (state_b, meta_b) = _final_state(a.CHECKPOINT_FOLDER), _final_state(
        b.CHECKPOINT_FOLDER)
    _assert_bitwise(state_b, state_a)
    assert meta_b == meta_a and meta_a["train_steps"] == 8
    assert _logged(b.TENSORBOARD_DIR) == _logged(a.TENSORBOARD_DIR)

    stamp = os.path.getmtime(os.path.join(ckpts[-1], ckpt_lib.TRAIN_STATE))
    HierarchicalTrainer(b).train()  # a third run has nothing left to do
    assert ckpt_lib.list_checkpoints(b.CHECKPOINT_FOLDER) == ckpts
    assert os.path.getmtime(os.path.join(ckpts[-1], ckpt_lib.TRAIN_STATE)) == stamp


# -- 5. options not ported yet ----------------------------------------------------------

@pytest.mark.parametrize("key,value,item", [
    ("TPU.MESH_AXES", ["batch", "model"], "the mesh has the axes"),
    ("TPU.MESH_SHAPE", [2, 2], "a grid of 4 ranks"),
    ("MODEL.BERT.pretrained_weights", "bert.npz", "§A item 8"),
])
def test_unported_options_raise_before_any_work(tmp_path, key, value, item):
    """Mesh axes other than ["data", "model"] raise before any work.  A
    "model" axis is the port's since it was ported (parallel/tensor.py):
    get_config takes [2, 2], and a trainer called outside a process group
    (not through run_exp, which starts the ranks) refuses the grid of 4
    ranks before any work.  The pretrained BERT file of the §A item 8 case
    is read since that item was ported (utils/pretrained.py): the trainer
    takes 2 steps from a tiny valid .npz and records it loaded."""
    if key == "MODEL.BERT.pretrained_weights":
        _trains_from_a_pretrained_bert(tmp_path, str(tmp_path / value))
        return
    options = dict(zip(key, value)) if isinstance(key, tuple) else {key: value}
    error = RuntimeError if key == "TPU.MESH_SHAPE" else NotImplementedError
    with pytest.raises(error, match=item):
        cfg = port_config(tmp_path, **options)
        assert list(cfg.TPU.MESH_SHAPE) == [2, 2]
        get_trainer(cfg.TRAINER_NAME)(cfg).train()
    assert not (tmp_path / "ckpts").exists() and not (tmp_path / "tb").exists()
    assert not (tmp_path / "train_buf").exists()


def _trains_from_a_pretrained_bert(tmp_path, path):
    from robo_vln_tpu_torch.models.encoders.bert import BertEncoder

    rng = np.random.default_rng(3)
    shapes = BertEncoder(vocab_size=60, hidden_size=16, num_layers=1, num_heads=2,
                         intermediate_size=32).state_dict()
    sd = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in shapes.items()}
    np.savez(path, **sd)
    buffers(tmp_path, n_eps=2, n_eval=0)
    cfg = port_config(tmp_path, batch_size=2, **{"MODEL.BERT.pretrained_weights": path})
    trainer = HierarchicalTrainer(cfg)
    trainer.train()
    assert trainer.pretrained_backbones["bert"] == {"status": "loaded", "path": path}
    assert trainer.pretrained_backbones["imagenet_rgb"]["status"] == "missing_file"
    _, meta = _final_state(cfg.CHECKPOINT_FOLDER)
    assert meta["train_steps"] == 2
    bert = trainer.high.embedding_layer.state_dict()  # the low level holds none
    for k, v in sd.items():
        assert np.array_equal(bert[k].numpy(), v), k


def test_jax_only_keys_are_listed_with_their_defaults():
    """Every key of the JAX package's default tree that the port's tree lacks
    is in the port's own table of keys it refuses past their default
    (jax_only.UNPORTED, each naming its ROADMAP item) or of keys no value of
    which matters (jax_only.INERT, each with its reason), with the JAX
    default; no key is in both, and none of them is in the port's tree."""
    jax_keys = {k: v for k, v in _port_keys(jax_defaults) if not k.startswith("TASK_CONFIG.")}
    port_keys = dict(_port_keys(port_defaults))
    listed = {**jax_only.UNPORTED, **jax_only.INERT}
    assert not set(jax_only.UNPORTED) & set(jax_only.INERT)
    assert set(listed) == set(jax_keys) - set(port_keys)
    for key, (default, why) in listed.items():
        assert default == jax_keys[key] and type(default) is type(jax_keys[key]), key
        assert why
    assert all(re.fullmatch(r"§[AC] (item \d+[a-z]?|C\d+)", item)
               for _, item in jax_only.UNPORTED.values())


@pytest.mark.parametrize("key,value,item", [
    ("TPU.MESH_AXES", ["data"], "the mesh has the axes"),
    ("TPU.MESH_SHAPE", [2, 2], None),
])
def test_jax_only_keys_refused_past_their_default(tmp_path, key, value, item):
    """get_config refuses, from a CLI option and from a yaml, a value of a
    JAX package key that the port does not compute, naming the ROADMAP item
    that would port it; at its JAX default, and for an inert key at any
    value, it loads (as do the port's yamls).  The mesh's keys are the
    port's own now: it refuses the mesh it does not build, other axes
    (``item`` the reason), and takes a "model" axis above 1 (tensor
    parallelism, ``item`` None), from a CLI option as from a yaml."""
    yaml_path = tmp_path / "exp.yaml"
    node = value
    for part in reversed(key.split(".")):
        node = {part: node}
    yaml_path.write_text(json.dumps(node))
    option = [key, json.dumps(value) if not isinstance(value, str) else value]
    if item is None:
        for cfg in (get_config(opts=option), get_config(str(yaml_path))):
            assert _lookup(cfg, key) == value
    else:
        with pytest.raises(NotImplementedError, match=f"{re.escape(key)} = .*{item}"):
            get_config(opts=option)
        with pytest.raises(NotImplementedError, match=item):
            get_config(str(yaml_path))
    assert key not in jax_only.UNPORTED and key not in jax_only.INERT
    default = _lookup(jax_defaults, key)
    assert _lookup(get_config(opts=[key, json.dumps(default)]), key) == default
    assert _lookup(port_defaults, key) == default
    get_config(opts=["TPU.DONATE", "False", "TPU.PARAM_DTYPE", "bfloat16"])
    for yaml_file in sorted(PORT_CONFIGS.glob("*.yaml")):
        if yaml_file.name != "robo_vln_task.yaml":
            get_config(str(yaml_file))


@pytest.mark.parametrize("key,value", [
    ("MODEL.RGB_ENCODER.cnn_type", "SimpleRGBCNN"),
    ("MODEL.DEPTH_ENCODER.cnn_type", "SimpleDepthCNN"),
    ("MODEL.ablate_instruction", True),
    ("MODEL.SEQ2SEQ.use_prev_action", True),
    ("MODEL.CMA.use", True),
    ("MODEL.CMA.use_prev_action", True),
    ("MODEL.PROGRESS_MONITOR.use", True),
    ("MODEL.PROGRESS_MONITOR.alpha", 0.5),
])
def test_flat_family_keys_are_read(key, value):
    """The flat family's keys, refused before the family was ported, are
    the port's own now, with the JAX defaults: get_config takes them past
    their default, from a CLI option as from the JAX package's tree."""
    cfg = get_config(opts=[key, json.dumps(value) if not isinstance(value, str) else value])
    assert _lookup(cfg, key) == value
    assert _lookup(port_defaults, key) == _lookup(jax_defaults, key)
    assert key not in jax_only.UNPORTED and key not in jax_only.INERT


@pytest.mark.parametrize("key,value", [
    ("VIDEO_OPTION", ["disk", "tensorboard"]),
    ("VIDEO_DIR", "videos/elsewhere"),
    ("PLOT_ATTENTION", True),
    ("EVAL.EVAL_NONLEARNING", True),
    ("EVAL.NONLEARNING.AGENT", "ExpertAgent"),
    ("MODEL.CMA.rcm_state_encoder", True),
])
def test_eval_extras_and_rcm_keys_are_read(key, value):
    """The eval's extras and the RCM switch, refused before their slice
    was ported, are the port's own keys now, with the JAX defaults:
    get_config takes them past their default (the runs:
    tests/test_torch_{eval_extras,nonlearning,flat_models}.py)."""
    cfg = get_config(opts=[key, json.dumps(value) if not isinstance(value, str) else value])
    assert _lookup(cfg, key) == value
    assert _lookup(port_defaults, key) == _lookup(jax_defaults, key)
    assert key not in jax_only.UNPORTED and key not in jax_only.INERT


@pytest.mark.parametrize("value", [True, False])
def test_pallas_attention_reaches_the_attention_setting(tmp_path, value):
    """TPU.PALLAS_ATTENTION, read since the port computes both of its
    functions: get_config takes either value, and the trainer's policy
    set-up and build_hcm_agent set ops/cm_attention's process-wide
    float32_probabilities from it, as the JAX trainers call
    set_use_pallas (hierarchical_trainer.py:65)."""
    from robo_vln_tpu_torch import build_hcm_agent
    from robo_vln_tpu_torch.ops import cm_attention

    assert "TPU.PALLAS_ATTENTION" not in jax_only.UNPORTED
    assert port_defaults.TPU.PALLAS_ATTENTION is False
    cfg = port_config(tmp_path, **{"TPU.PALLAS_ATTENTION": value})
    assert cfg.TPU.PALLAS_ATTENTION is value
    try:
        cm_attention.set_float32_probabilities(not value)
        HierarchicalTrainer(cfg)._setup_policy()
        assert cm_attention.float32_probabilities() is value
        cm_attention.set_float32_probabilities(not value)
        build_hcm_agent(cfg.MODEL, device="cpu", compute_dtype="float32",
                        pallas_attention=cfg.TPU.PALLAS_ATTENTION)
        assert cm_attention.float32_probabilities() is value
    finally:
        cm_attention.set_float32_probabilities(False)


def test_eval_raises(tmp_path):
    """HierarchicalTrainer.eval() evaluates a port checkpoint on the CPU (the
    kinematic backend, EVAL_CKPT_PATH_DIR naming the checkpoint itself) and
    writes its stats; it raises, before any rollout, on a checkpoint it
    cannot read (a JAX package orbax directory)."""
    from tests.test_envs import make_episode_json

    extra = {"TASK_CONFIG.SIMULATOR.TYPE": "kinematic",
             "TASK_CONFIG.DATASET.DATA_PATH": make_episode_json(tmp_path, n_eps=1),
             "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 3, "EVAL.SPLIT": "train",
             "EVAL.EPISODE_COUNT": 1, "EVAL.VAL_LOG_DIR": str(tmp_path / "val"),
             "MODEL.INSTRUCTION_ENCODER.is_bert": True}
    cfg = port_config(tmp_path, batch_size=1, **extra)
    trainer = HierarchicalTrainer(cfg)
    trainer._setup_policy()
    trainer.save_checkpoint("ckpt.0")
    ckpt = str(tmp_path / "ckpts" / "ckpt.0")
    HierarchicalTrainer(port_config(tmp_path, batch_size=1, EVAL_CKPT_PATH_DIR=ckpt,
                                    **extra)).eval()
    stats = json.loads((tmp_path / "val" / "stats_ckpt_0_train.json").read_text())
    assert stats["steps_taken"] == 3 and np.isfinite(stats["ndtw"])
    orbax = tmp_path / "orbax" / "ckpt.0"
    (orbax / "state").mkdir(parents=True)
    ckpt_lib.write_metadata(str(orbax), {"config": {}})
    with pytest.raises(ValueError, match="not a checkpoint the port reads"):
        HierarchicalTrainer(port_config(tmp_path, batch_size=1,
                                        EVAL_CKPT_PATH_DIR=str(orbax), **extra)).eval()


# -- 6. the entry point ------------------------------------------------------------------

def _cli_opts(tmp_path):
    return [str(x) if not isinstance(x, list) else json.dumps(x)
            for x in tiny_opts(tmp_path, batch_size=4)]


def test_entry_point_trains_on_the_cpu(tmp_path):
    buffers(tmp_path, n_eps=8, n_eval=4)
    cmd = [sys.executable, "-m", "robo_vln_tpu_torch.run", "--run-type", "train",
           "--exp-config", str(PORT_CONFIGS / "hierarchical_cma.yaml"), *_cli_opts(tmp_path)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert [os.path.basename(c) for c in ckpt_lib.list_checkpoints(tmp_path / "ckpts")] == [
        "ckpt.1"]
    tags = {tag for tag, _, _ in _logged(tmp_path / "tb")}
    assert {"Train High Level Action Loss", "Val High Level Loss", "Validation Accuracy"} <= tags
    meta = ckpt_lib.load_metadata(tmp_path / "ckpts" / "ckpt.1")
    assert meta["train_steps"] == 4 and meta["config"]["DEVICE"] == "cpu"


def test_entry_point_needs_cuda_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = _cli_opts(tmp_path)
    opts = opts[2:] if opts[:2] == ["DEVICE", "cpu"] else pytest.fail("DEVICE first")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_exp(str(PORT_CONFIGS / "hierarchical_cma.yaml"), "train", opts)
