"""The port's checkpoints (training/checkpoint.py) and the trainer's resume
bookkeeping, against the JAX package where it has a counterpart.

* A save and load round trip restores the parameters, both optimizers'
  Adam moments and step counts, the trainer's step counters and
  ``scheduler_step`` bitwise; an optimizer built over other parameters, or
  the same ones in another order, is refused before any state is loaded.
* ``list_checkpoints`` orders by index (``ckpt.10`` after ``ckpt.9``), as the
  JAX package's does.
* ``_find_resume`` and ``_iteration_plan`` equal the JAX ``BaseTrainer``'s
  over a grid of EPOCHS, ITERATIONS, MAX_EPOCHS_PER_RUN and start epochs
  (plain Python on both sides).
* The JAX package's ``convert_hierarchical_checkpoint`` reads a port
  checkpoint's state dicts into a tree equal, bitwise, to the port's
  parameters.
* A reference-layout ``.pth``, written from the torch mirrors of the
  reference's modules (tests/test_checkpoint_convert.py), loads into the
  port trainer bitwise equal to what the JAX converter makes of it; a
  missing or unexpected key raises and names the key.
"""

import itertools
import os
import shutil

import numpy as np
import pytest
import torch

from robo_vln_tpu.training import checkpoint as jax_ckpt
from robo_vln_tpu.training.trainer import BaseTrainer as JaxBaseTrainer
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
from robo_vln_tpu_torch.training.trainer import BaseTrainer
from robo_vln_tpu_torch.utils.weight_port import high_level_state_dict, low_level_state_dict
from tests.test_torch_trainer import buffers, port_config
from tests.test_torch_threads import one_torch_thread  # noqa: F401

BLOCKS = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(trainer, checkpoint path): a tiny port trainer after one epoch (4
    steps: Adam moments, step counters and the schedule all moved), its
    checkpoint saved.  Tests that alter the checkpoint copy it first."""
    tmp_path = tmp_path_factory.mktemp("trained")
    buffers(tmp_path, n_eps=8, n_eval=0)
    trainer = HierarchicalTrainer(port_config(tmp_path, batch_size=4))
    trainer._setup_policy()
    trainer._scheduler_step = 3

    class Quiet:
        def add_scalar(self, *args):
            pass

    trainer.train_epoch(trainer._batches(trainer.features_dir, seed=0), 0, Quiet(), 7)
    return trainer, os.path.join(trainer.config.CHECKPOINT_FOLDER, "ckpt.1")


def _optimizer_state(opt, module):
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: s for p, s in opt.state.items()}


def test_round_trip_is_bitwise(trained):
    trainer, path = trained
    fresh = HierarchicalTrainer(trainer.config)
    fresh._setup_policy(True, path)
    for level in ("high", "low"):
        got, want = getattr(fresh, level), getattr(trainer, level)
        sd_got, sd_want = got.state_dict(), want.state_dict()
        assert sd_got.keys() == sd_want.keys()
        for k in sd_want:
            assert torch.equal(sd_got[k], sd_want[k]), k
        opt_got = _optimizer_state(getattr(fresh.state, level).optimizer, got)
        opt_want = _optimizer_state(getattr(trainer.state, level).optimizer, want)
        assert opt_got.keys() == opt_want.keys() and len(opt_want) > 10
        for name, state in opt_want.items():
            for k, v in state.items():
                assert torch.equal(opt_got[name][k], v), (level, name, k)
        assert getattr(fresh.state, level).step == getattr(trainer.state, level).step == 4
    meta = ckpt_lib.load_metadata(path)
    assert (meta["scheduler_step"], meta["train_steps"]) == (5, 11)
    assert meta["config"]["DAGGER"]["BATCH_SIZE"] == 4
    with torch.no_grad():  # a load overwrites, it does not merge
        next(fresh.high.parameters()).add_(1.0)
    fresh._setup_policy(True, path)
    assert torch.equal(next(fresh.high.parameters()), next(trainer.high.parameters()))


@pytest.mark.parametrize("change", ["bert_trainable", "order"])
def test_other_optimizer_layout_is_refused(trained, tmp_path, change):
    trainer, path = trained
    if change == "bert_trainable":
        config = port_config(tmp_path, batch_size=4, **{"MODEL.BERT.trainable": True})
        match = "saved only: \\[\\]; rebuilt only: \\['embedding_layer"
    else:
        path = shutil.copytree(path, tmp_path / "ckpt.1")
        file = os.path.join(path, ckpt_lib.TRAIN_STATE)
        saved = torch.load(file, weights_only=True)
        names = saved["low_param_names"]
        names[0], names[1] = names[1], names[0]
        torch.save(saved, file)
        config, match = trainer.config, "same names, other order"
    fresh = HierarchicalTrainer(config)
    with pytest.raises(ValueError, match=match):
        fresh._setup_policy(True, path)


def test_list_checkpoints_orders_by_index(tmp_path):
    for name in ("ckpt.10", "ckpt.9", "ckpt.2", "ckpt.x", "other", "ckpt.100"):
        (tmp_path / name).mkdir()
    want = [str(tmp_path / f"ckpt.{i}") for i in (2, 9, 10, 100)]
    assert ckpt_lib.list_checkpoints(str(tmp_path)) == want
    assert jax_ckpt.list_checkpoints(str(tmp_path)) == want
    assert ckpt_lib.list_checkpoints(str(tmp_path / "absent")) == []


class _Trainers:
    """A port and a JAX BaseTrainer over one config: the bookkeeping needs
    nothing else."""

    def __init__(self, config):
        self.port, self.jax = object.__new__(BaseTrainer), object.__new__(JaxBaseTrainer)
        self.port.config = self.jax.config = config


@pytest.mark.parametrize("epochs,iterations", itertools.product((1, 2, 3), (1, 2, 3)))
def test_resume_bookkeeping_matches_jax(tmp_path, epochs, iterations):
    for budget in (0, 1, 2, 5):
        config = get_config(opts=["DAGGER.EPOCHS", epochs, "DAGGER.ITERATIONS", iterations,
                                  "DAGGER.MAX_EPOCHS_PER_RUN", budget,
                                  "CHECKPOINT_FOLDER", str(tmp_path / f"c{budget}")])
        t = _Trainers(config)
        assert t.port._total_epochs == t.jax._total_epochs
        for start in range(epochs * iterations + 2):
            assert t.port._iteration_plan(start) == t.jax._iteration_plan(start), (budget, start)
        folder = tmp_path / f"c{budget}"
        assert t.port._find_resume() == t.jax._find_resume() == (0, "", {})
        for index in (0, epochs - 1, epochs, epochs + 1, 3 * epochs):
            ckpt = folder / f"ckpt.{index}"
            ckpt.mkdir(parents=True, exist_ok=True)
            ckpt_lib.write_metadata(str(ckpt), {"train_steps": index, "scheduler_step": 1})
            assert t.port._find_resume() == t.jax._find_resume(), (budget, index)


def test_jax_converter_reads_a_port_checkpoint(trained):
    trainer, path = trained
    saved = torch.load(os.path.join(path, ckpt_lib.TRAIN_STATE), weights_only=True)
    high_vars, low_vars = jax_ckpt.convert_hierarchical_checkpoint(
        {k: {n: v.numpy() for n, v in saved[k].items()}
         for k in ("high_level_state_dict", "low_level_state_dict")}, blocks=BLOCKS)
    for module, got in ((trainer.high, high_level_state_dict(high_vars)),
                        (trainer.low, low_level_state_dict(low_vars))):
        want = module.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k], v.numpy()), k


def _reference_pth(tmp_path, drop=None, extra=None):
    """A reference-layout .pth from the torch mirrors of the reference's two
    policies, with random BatchNorm statistics and a plain-dict config."""
    from tests.test_checkpoint_convert import TorchHighLevelCMA, TorchLowLevel

    torch.manual_seed(0)
    high, low = TorchHighLevelCMA().eval(), TorchLowLevel().eval()
    for m in list(high.modules()) + list(low.modules()):
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    ckpt = {"high_level_state_dict": high.state_dict(),
            "low_level_state_dict": low.state_dict(), "config": {"TRAINER_NAME": "x"}}
    if drop:
        del ckpt["high_level_state_dict"][drop]
    if extra:
        ckpt["low_level_state_dict"][extra] = torch.zeros(1)
    path = str(tmp_path / "HCM_Agent.pth")
    torch.save(ckpt, path)
    return path, ckpt


def mirror_trainer(tmp_path):
    """The port trainer at the mirrors' sizes (tests/test_checkpoint_convert.py)."""
    sizes = {"BERT.hidden_size": 32, "BERT.num_layers": 2, "BERT.num_heads": 2,
             "BERT.intermediate_size": 64, "BERT.vocab_size": 60,
             "BERT.max_position_embeddings": 40, "VISUAL_LING_ATTN.d_model": 16,
             "VISUAL_LING_ATTN.h": 2, "VISUAL_LING_ATTN.d_ff": 32,
             "VISUAL_LING_ATTN.vis_in_features": 16, "VISUAL_LING_ATTN.ins_in_features": 32}
    sensors = {f"TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.{d}": 64 for d in ("WIDTH", "HEIGHT")}
    trainer = HierarchicalTrainer(port_config(
        tmp_path, **{f"MODEL.{k}": v for k, v in sizes.items()}, **sensors))
    trainer._setup_policy()
    return trainer


def test_reference_pth_loads_like_the_jax_converter(tmp_path):
    path, ckpt = _reference_pth(tmp_path)
    trainer = mirror_trainer(tmp_path)
    counts = ckpt_lib.load_reference_checkpoint(trainer, path)
    high_vars, low_vars = jax_ckpt.convert_hierarchical_checkpoint(
        {k: {n: v.numpy() for n, v in ckpt[k].items()}
         for k in ("high_level_state_dict", "low_level_state_dict")}, blocks=BLOCKS)
    for level, module, want in (("high", trainer.high, high_level_state_dict(high_vars)),
                                ("low", trainer.low, low_level_state_dict(low_vars))):
        got = module.state_dict()
        assert got.keys() == want.keys() and counts[level] == len(got)
        for k, v in got.items():
            assert np.array_equal(v.numpy(), want[k]), (level, k)
    skipped = set(ckpt["high_level_state_dict"]) - set(trainer.high.state_dict())
    assert {k.split(".")[0] for k in skipped} == {"ins_fc", "embedding_layer", "rgb_encoder"}


@pytest.mark.parametrize("drop,extra,named", [
    ("linear.weight", None, "Missing key.*linear.weight"),
    (None, "stray.weight", "Unexpected key.*stray.weight")])
def test_reference_pth_with_wrong_keys_raises(tmp_path, drop, extra, named):
    path, _ = _reference_pth(tmp_path, drop=drop, extra=extra)
    trainer = mirror_trainer(tmp_path)
    with pytest.raises(RuntimeError, match=named):
        ckpt_lib.load_reference_checkpoint(trainer, path)
