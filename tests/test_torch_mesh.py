"""The data-parallel mesh (parallel/mesh.py) and the sharded train and val
steps (training/steps.py with ``mesh``) against the JAX package's
single-device step and the port's one-process step, on the CPU.

Two and four ranks of a gloo group are spawned (tests/torch_mesh_ranks.py,
one torch thread each); each steps on its rows of the same global windows,
B=4, T=4, two windows with the hidden state carried:

* the HCM (tests/test_torch_agent's tiny HCM, synced trunks, the shared
  trunk pass; AdamW and Adam, weight decay 1e-3, lr 1e-4) and the flat
  Seq2Seq with the progress monitor (tests/test_torch_flat_train's
  ``seq2seq_pm``; Adam), both float32 with dropout off;
* the HCM again with TPU.VALID_MASK_VELOCITY_MSE and the inflection-
  weighted CE (``hier_dev``: the real steps and the summed weights as
  denominators);
* the shards' counts differ: rows 0-1 hold an episode padded after two
  steps and one all padding, rows 2-3 full episodes, with ignored oracle
  steps and exact zero velocity targets, so that every denominator (the
  real episodes, the velocity elements, the stop targets, the labelled
  steps, the progress monitor's steps) differs between ranks.

Each rank's losses and accuracy, its rows of both hidden states, every
trainable gradient and the parameters after each step are held to the JAX
package's step on the global batch (``jax.grad`` of its losses for the
gradients) at tests/test_torch_train_step.py's tolerances: 1e-4 for losses,
hidden states and gradients; the parameters within 0.01·lr where the
reference gradient stayed above 1e-6, within 2·lr a step elsewhere; and
the same against the port's one-process step on the same global batch.
The val step's metrics and hidden rows, on the first window after the
steps, are held the same way.  Every
rank's parameters are bitwise equal after each step.

A non-finite loss in the last rank's rows skips the update on every rank.
Rank 0's own work (on_main) may outlast the step group's timeout while the
other ranks wait.
With per-rank denominators (each rank dividing by its own counts, the mean
of per-rank means), the same checks fail.  A ``[d, m]`` grid resolves as
make_mesh resolves it, axis names other than ["data", "model"] are refused
before any work, and ``dryrun_multichip(4)`` runs both its phases (the
model axis itself: tests/test_torch_tensor_parallel.py).
"""

import copy
import datetime
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.parallel import mesh as jax_mesh
from robo_vln_tpu.training import steps as jax_steps
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.parallel import mesh as mesh_lib
from robo_vln_tpu_torch.utils.weight_port import (flat_state_dict, high_level_state_dict,
                                                  low_level_state_dict)
from tests import torch_mesh_ranks
from tests.test_torch_agent import make_inputs
from tests.test_torch_flat_models import flat_inputs
from tests.test_torch_flat_train import ALPHA, CASES
from tests.test_torch_flat_train import jax_programs as flat_jax_programs
from tests.test_torch_flat_train import port_setup as flat_port_setup
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import (GRAD_FLOOR, LR, TOL, _extras, _port_names, jax_programs,
                                         jax_setup, port_setup)
from tests.test_torch_flat_models import jax_flat

B, T, WINDOWS = 4, 4, 2
FLAT = "seq2seq_pm"
assert LR == torch_mesh_ranks.LR


def _pad(arrays, rows, steps):
    valid, oracle, corrected, stop = arrays
    valid[rows, steps] = 0.0
    corrected[rows, steps] = 0.0
    stop[rows, steps] = -1.0
    if oracle is not None:
        oracle[rows, steps] = 0.0


def _labels(rng, window, hier):
    """valid_mask, oracle, corrected, stop of a global window whose shards'
    counts differ: row 0 padded after 2 steps (window 0) or 1, row 1 all
    padding, rows 2-3 real, an ignored label and exact zero targets."""
    valid = np.ones((B, T), np.float32)
    oracle = rng.integers(1, 5, (B, T)).astype(np.float32) if hier else None
    corrected = rng.random((B, T, 2)).astype(np.float32)
    stop = (rng.random((B, T, 1)) > 0.6).astype(np.float32)
    arrays = (valid, oracle, corrected, stop)
    _pad(arrays, 0, slice(2 - window, None))
    _pad(arrays, 1, slice(None))
    corrected[2, 1, 1] = 0.0
    corrected[3, 2, 0] = 0.0  # outside the progress monitor's mask too
    if hier:
        oracle[3, 0] = 0.0  # an ignored label on a real step
    return arrays


def hier_windows(seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for window in range(WINDOWS):
        obs, masks = make_inputs(rng, B, T)
        valid, oracle, corrected, stop = _labels(rng, window, True)
        out.append({**obs, "vln_oracle_action_sensor": oracle,
                    "prev_actions": rng.standard_normal((B, T, 2)).astype(np.float32),
                    "corrected_actions": corrected, "oracle_stop": stop,
                    "not_done_masks": masks, "valid_mask": valid})
    return out


def flat_windows(seed=22):
    rng = np.random.default_rng(seed)
    px = CASES[FLAT][0]
    out = []
    for window in range(WINDOWS):
        obs, masks, prev = flat_inputs(rng, px, b=B)
        valid, _, corrected, stop = _labels(rng, window, False)
        out.append({**obs, "progress": rng.random((B, T)).astype(np.float32),
                    "prev_actions": prev, "corrected_actions": corrected,
                    "oracle_stop": stop, "not_done_masks": masks, "valid_mask": valid})
    return out


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(x):
    return np.asarray(x, np.float32)


# -- the references: the JAX package's single-device step and the port's one process --

def jax_hier_reference(windows, deviations=False):
    _, jhigh, jlow, high_vars, low_vars = jax_setup()
    jstep, jgrads, tx_h, tx_l = jax_programs(deviations)
    hp, lp = high_vars["params"], low_vars["params"]
    state = jax_steps.HierTrainState(
        jax_steps.TrainState(hp, tx_h.init(hp), jnp.asarray(0)),
        jax_steps.TrainState(lp, tx_l.init(lp), jnp.asarray(0)))
    hh, lh = jhigh.initial_hidden(B), jlow.initial_hidden(B)
    levels = (("high", high_vars, high_level_state_dict), ("low", low_vars, low_level_state_dict))
    out = []
    for window in windows:
        batch = jax.tree.map(jnp.asarray, window)
        grads = jgrads(state.high.params, state.low.params, batch, hh, lh)
        state, hh, lh, metrics = jstep(state, hh, lh, batch, LR, LR)
        out.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "hidden": [_np(hh), _np(lh)],
            "grads": {f"{lv}.{n}": v for (lv, var, sd), g in zip(levels, grads)
                      for n, v in _port_names(g, var, sd).items()},
            "params": {f"{lv}.{n}": v for (lv, var, sd), p in zip(
                levels, (state.high.params, state.low.params))
                for n, v in _port_names(p, var, sd).items()}})
    val = jax_steps.make_hier_val_step(
        torch_bound(jhigh, high_vars), torch_bound(jlow, low_vars), trunk_fn=_jax_trunk(),
        valid_velocity_mse=deviations)
    vh, vl, metrics = val(state.high.params, state.low.params, jhigh.initial_hidden(B),
                          jlow.initial_hidden(B), jax.tree.map(jnp.asarray, windows[0]))
    return out, {"metrics": {k: float(v) for k, v in metrics.items()},
                 "hidden": [_np(vh), _np(vl)]}


def torch_bound(policy, variables):
    from tests.test_torch_train_step import _Bound

    return _Bound(policy, _extras(variables))


def _jax_trunk():
    from robo_vln_tpu.models import make_shared_trunk_fn as jax_trunk_fn

    jax_mc, _, _, high_vars, _ = jax_setup()
    return jax_trunk_fn(jax_mc, jnp.float32, _extras(high_vars))


def jax_flat_reference(windows):
    _, _, jpolicy, variables, _ = jax_flat(*CASES[FLAT])
    jstep, jgrads, tx, bound = flat_jax_programs(FLAT)
    params = variables["params"]
    state = jax_steps.TrainState(params, tx.init(params), jnp.asarray(0))
    h = jpolicy.initial_hidden(B)
    out = []
    for window in windows:
        batch = jax.tree.map(jnp.asarray, window)
        grads = jgrads(state.params, batch, h)
        state, h, metrics = jstep(state, h, batch, LR)
        out.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "hidden": [_np(h)],
            "grads": {f"policy.{n}": v
                      for n, v in _port_names(grads, variables, flat_state_dict).items()},
            "params": {f"policy.{n}": v
                       for n, v in _port_names(state.params, variables, flat_state_dict).items()}})
    val = jax.jit(jax_steps.make_flat_val_step(bound, use_progress=True, progress_alpha=ALPHA))
    vh, metrics = val(state.params, jpolicy.initial_hidden(B),
                      jax.tree.map(jnp.asarray, windows[0]))
    return out, {"metrics": {k: float(v) for k, v in metrics.items()}, "hidden": [_np(vh)]}


def port_reference(kind, windows):
    """The port's one-process step on the global batch (no process group),
    and the case its ranks run: the same starting policies.  "hier_dev":
    the HCM with TPU.VALID_MASK_VELOCITY_MSE and inflection-weighted CE."""
    if kind.startswith("hier"):
        deviations = kind == "hier_dev"
        high, low, _, _, _ = port_setup(deviations)
        case = {"kind": "hier", "modules": {"high": copy.deepcopy(high),
                                            "low": copy.deepcopy(low)}}
        if deviations:
            case.update(valid_velocity_mse=True,
                        inflection_coef=get_config().MODEL.inflection_weight_coef)
    else:
        policy, _, _ = flat_port_setup(FLAT)
        case = {"kind": "flat", "alpha": ALPHA, "modules": {"policy": copy.deepcopy(policy)}}
    ref = torch_mesh_ranks.run_case({**case, "windows": windows}, mesh_lib.DataMesh("cpu"))
    return case, ref


# -- the ranks -----------------------------------------------------------------------

def run_ranks(job, n):
    out = job.parent / f"out{n}"
    out.mkdir()
    mesh_lib.spawn(torch_mesh_ranks.rank_main, n, "cpu", str(job), str(out), timeout_s=600)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def setups():
    """(cases for the ranks, JAX references, port references), by kind."""
    windows = {"hier": hier_windows(), "flat": flat_windows()}
    windows["hier_dev"] = windows["hier"]
    jax_refs = {"hier": jax_hier_reference(windows["hier"]),
                "hier_dev": jax_hier_reference(windows["hier"], deviations=True),
                "flat": jax_flat_reference(windows["flat"])}
    cases, port_refs = {}, {}
    for kind, w in windows.items():
        case, ref = port_reference(kind, w)
        cases[kind] = {**case, "windows": w}
        cases[f"{kind}_local"] = {**case, "windows": w, "counts": "local"}
        port_refs[kind] = (ref["windows"], ref["val"])
    bad = copy.deepcopy(windows["hier"][:1])
    bad[0]["corrected_actions"][3, 1, 0] = np.nan  # the last rank's rows
    cases["hier_nan"] = {**cases["hier"], "windows": bad}
    bad = copy.deepcopy(windows["flat"][:1])
    bad[0]["corrected_actions"][3, 1, 0] = np.nan
    cases["flat_nan"] = {**cases["flat"], "windows": bad}
    return cases, jax_refs, port_refs


@pytest.fixture(scope="module")
def rank_results(setups, tmp_path_factory):
    cases, _, _ = setups
    root = tmp_path_factory.mktemp("mesh")
    torch.save(cases, root / "job.pt")
    results = {n: run_ranks(root / "job.pt", n) for n in (2, 4)}
    shutil.rmtree(root)  # the policies and every rank's results: hundreds of MB
    return results


def _rows(x, rank, n):
    b = x.shape[-2] // n
    return x[..., rank * b:(rank + 1) * b, :]


def check_ranks(results, ref_windows, ref_val, n):
    """Every rank's windows and val step against a reference."""
    steady = {}
    for w, ref in enumerate(ref_windows):
        params0 = results[0]["windows"][w]["params"]
        for rank, res in enumerate(results):
            got = res["windows"][w]
            for key, want in ref["metrics"].items():
                np.testing.assert_allclose(got["metrics"][key], want, atol=TOL, rtol=0,
                                           err_msg=f"rank {rank} window {w} {key}")
            for h, want in zip(got["hidden"], ref["hidden"]):
                np.testing.assert_allclose(_np(h), _rows(_np(want), rank, n), atol=TOL,
                                           rtol=0, err_msg=f"rank {rank} window {w} hidden")
            # the trainable leaves; the JAX reference also names the frozen
            # ones, with zeros
            trainable = results[0]["windows"][w]["grads"]
            assert set(got["grads"]) == set(trainable) and set(trainable) <= set(ref["grads"])
            for name, g in got["grads"].items():
                np.testing.assert_allclose(_np(g), _np(ref["grads"][name]), atol=TOL, rtol=0,
                                           err_msg=f"rank {rank} window {w} grad {name}")
            for name, p in got["params"].items():
                assert torch.equal(p, params0[name]), f"rank {rank}'s {name} parted"
        for name in results[0]["windows"][w]["grads"]:
            big = np.abs(_np(ref["grads"][name])) > GRAD_FLOOR
            steady[name] = big & steady.get(name, True)
            err = np.abs(_np(params0[name]) - _np(ref["params"][name]))
            assert err.max() <= 2 * LR * (w + 1), name
            assert (err[steady[name]] <= 0.01 * LR).all(), name
    for rank, res in enumerate(results):
        for key, want in ref_val["metrics"].items():
            np.testing.assert_allclose(res["val"]["metrics"][key], want, atol=TOL, rtol=0,
                                       err_msg=f"rank {rank} val {key}")
        for h, want in zip(res["val"]["hidden"], ref_val["hidden"]):
            np.testing.assert_allclose(_np(h), _rows(_np(want), rank, n), atol=TOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["hier", "hier_dev", "flat"])
def test_sharded_step_matches_jax_single_device(setups, rank_results, kind, n):
    _, jax_refs, _ = setups
    check_ranks([r[kind] for r in rank_results[n]], *jax_refs[kind], n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["hier", "hier_dev", "flat"])
def test_sharded_step_matches_the_one_process_step(setups, rank_results, kind, n):
    _, _, port_refs = setups
    check_ranks([r[kind] for r in rank_results[n]], *port_refs[kind], n)


def test_the_shards_counts_differ(setups):
    """Each denominator differs between the two ranks' rows (and the
    global count is not twice either), so a per-rank division would show."""
    cases, _, _ = setups
    from robo_vln_tpu_torch.training.steps import batch_counts

    for kind, extra in (("hier", {}), ("hier_dev", {"inflection_coef": get_config().MODEL.inflection_weight_coef}),
                        ("flat", {"progress": True})):
        for window in cases[kind]["windows"]:
            shards = [batch_counts(_t({k: v[r * 2:(r + 1) * 2] for k, v in window.items()}),
                      **extra) for r in range(2)]
            for key in shards[0]:
                if key not in ("episodes", "elements"):
                    assert shards[0][key] != shards[1][key], (kind, key)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["hier", "hier_dev", "flat"])
def test_per_rank_denominators_fail_the_check(setups, rank_results, kind, n):
    _, jax_refs, _ = setups
    with pytest.raises(AssertionError):
        check_ranks([r[f"{kind}_local"] for r in rank_results[n]], *jax_refs[kind], n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["hier", "flat"])
def test_a_nonfinite_shard_skips_the_update_on_every_rank(rank_results, kind, n):
    for rank, res in enumerate(rank_results[n]):
        got = res[f"{kind}_nan"]["windows"][0]
        assert got["grads"] == {}, rank
        for name, p in got["params"].items():
            assert torch.equal(p, res[f"{kind}_nan"]["start"][name]), (rank, name)
        if kind == "flat":
            assert got["metrics"]["skipped_nonfinite"] == 1.0
            assert not np.isfinite(got["metrics"]["action_loss"])
        else:
            assert not np.isfinite(got["metrics"]["low_level_action_loss"])


@pytest.mark.parametrize("shape,axes", [([2, 2], ["data", "model"]), ([-1, 2], ["data", "model"]),
                                        ([4, 1], ["batch", "model"])])
def test_a_model_axis_is_refused_before_any_work(tmp_path, shape, axes, monkeypatch):
    """Axes other than ["data", "model"] are refused before any work; a
    "model" axis is taken, and resolves as JAX's make_mesh resolves it on 4
    cards (on the CPU, -1 is one process), without a training run."""
    from tests.test_torch_trainer import tiny_opts
    from robo_vln_tpu_torch.run import run_exp

    opts = tiny_opts(tmp_path, **{"TPU.MESH_SHAPE": shape, "TPU.MESH_AXES": axes})
    if axes != ["data", "model"]:
        with pytest.raises(NotImplementedError, match="the mesh has the axes"):
            run_exp(None, "train", opts)
    else:
        cfg = get_config(opts=opts)
        jax_shape = dict(jax_mesh.make_mesh(shape, axes, jax.devices()[:4]).shape)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert mesh_lib.mesh_axes(cfg.TPU.MESH_SHAPE, "cuda") == (jax_shape["data"],
                                                                   jax_shape["model"]) == (2, 2)
        assert mesh_lib.mesh_axes(cfg.TPU.MESH_SHAPE, "cpu") == (shape[0] if shape[0] > 0 else 1,
                                                                  2)
    assert not (tmp_path / "ckpts").exists() and not (tmp_path / "tb").exists()


def test_the_data_axis_resolves_as_make_mesh_does(monkeypatch):
    assert mesh_lib.mesh_axes([-1, 1], "cpu") == (1, 1)
    assert mesh_lib.mesh_axes([3, 1], "cpu") == (3, 1)
    assert mesh_lib.mesh_axes([2, -1], "cpu") == (2, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_lib.mesh_axes([-1, 1], "cuda") == (4, 1)
    assert mesh_lib.mesh_axes([2, 1], "cuda") == (2, 1)
    assert mesh_lib.mesh_axes([1, -1], "cuda") == (1, 4)
    with pytest.raises(RuntimeError, match="4 CUDA devices are visible"):
        mesh_lib.mesh_axes([8, 1], "cuda")
    with pytest.raises(RuntimeError, match="4 CUDA devices are visible"):
        mesh_lib.mesh_axes([2, 4], "cuda")
    with pytest.raises(RuntimeError, match="do not divide over 3"):
        mesh_lib.mesh_axes([-1, 3], "cuda")
    # a group that is up holds the grid: -1 fills it, another count raises
    assert mesh_lib.mesh_axes([-1, 2], "cuda", ranks=2) == (1, 2)
    with pytest.raises(RuntimeError, match="the process group holds 2"):
        mesh_lib.mesh_axes([2, 2], "cuda", ranks=2)
    assert mesh_lib.global_batch_size(3, 4) == 12
    for shape in ([2, 1], [1, 2]):
        cfg = get_config(opts=["TPU.MESH_SHAPE", shape])
        with pytest.raises(RuntimeError, match="a process a rank"):
            mesh_lib.DataMesh.for_config(cfg, "cpu")


def test_dropout_masks_differ_by_rank():
    """Each rank draws its own masks; rank 0's are the one-process step's."""
    from robo_vln_tpu_torch.training.steps import dropout_generator

    draw = [torch.rand(64, generator=dropout_generator(3, "cpu", rank)) for rank in (0, 1, 2)]
    one_process = torch.rand(64, generator=dropout_generator(3, "cpu"))
    assert torch.equal(draw[0], one_process)
    assert not torch.equal(draw[0], draw[1]) and not torch.equal(draw[1], draw[2])
    assert not torch.equal(draw[1], torch.rand(64, generator=dropout_generator(4, "cpu", 1)))


def test_rank_zero_work_outlasts_the_step_groups_timeout(tmp_path):
    """The other ranks wait for rank 0's on_main work (collection,
    featurizing) in the mesh's own gloo group, so that work may take longer
    than the step group's timeout (NCCL's watchdog: 10 minutes by default),
    here 2 s against 6 s of work."""
    mesh_lib.spawn(torch_mesh_ranks.slow_main_rank, 2, "cpu", str(tmp_path), 6.0,
                   timeout_s=120, group_timeout=datetime.timedelta(seconds=2))
    for rank in (0, 1):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        assert got == {"value": {"from": "rank 0"}, "sum": 2.0}


def test_dryrun_multichip_runs(capfd):
    from robo_vln_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)
    out = capfd.readouterr().out
    assert "dryrun_multichip(4) ok (gloo): high_level_loss=" in out
    assert "dryrun_multichip(4) dp x tp (2 x 2) ok: 34 tensor-sharded kernels (high 30, low 4), " \
           "high_level_loss=" in out


@pytest.mark.parametrize("cards", [1, 3])
def test_dryrun_multichip_refuses_fewer_cards_than_ranks(monkeypatch, cards):
    """Where a card is visible the default puts a rank on each card: fewer
    cards than ranks raise before any rank starts, naming the one-card
    form, instead of running on the CPU."""
    from robo_vln_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh_lib, "spawn", lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(RuntimeError, match=f"{cards} CUDA devices are visible: pass "
                                           "device='cuda:0', backend='gloo'"):
        dryrun.dryrun_multichip(4)
