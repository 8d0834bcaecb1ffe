"""Runs of the harness on the CPU at tiny sizes, past its look for a card:
the result line's keys, the guard against JAX, the reference held to the
port and the control failing it, and each fault a cell can have turning
``correct`` false."""

import ast
import json
import os
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from hcmbench import harness
from hcmbench.drivers import train
from hcmbench.run import execute
from hcmbench.tests.tiny import CpuCard, tiny_cell

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
TRAIN = [c for c in CELLS if harness.load_cell(c).mix["driver"] == "train"]
ONE_CARD_TRAIN = [c for c in TRAIN if harness.load_cell(c).mix.get("ranks", 1) == 1]
EVAL = [c for c in CELLS if harness.load_cell(c).mix["driver"] == "eval_ondevice"]


def _run(cell):
    line, text, found = execute(cell, time.time())
    assert found == []
    return json.loads(line), text


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_line(name):
    """Each driver end to end on the CPU: the last line's keys, the numbers
    compared beside their limits, the end-to-end metrics, ``correct``."""
    out, text = _run(tiny_cell(name, precision="float32"))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(harness.load_cell(name).limits)
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    assert text.splitlines() and all(line.startswith("check ") for line in text.splitlines())
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.parametrize("name", [CELLS[0], EVAL[0]] + [c for c in TRAIN if c not in ONE_CARD_TRAIN])
def test_traced_rehearsal_reads_per_layer_metrics_only(name):
    out, _ = _run(tiny_cell(name, precision="float32"))
    traced = tiny_cell(name, precision="float32")
    traced.trace = True
    out, _ = _run(traced)
    per_layer = {m["name"] for m in harness.load_cell(name).per_layer}
    assert out["correct"] is True and set(out["metrics"]) <= per_layer and out["metrics"]
    if traced.mix.get("trace_window"):  # the window's tail, read per layer on several ranks
        assert out["metrics"]["train_step_ms_p95.mesh"]["value"] > 0


GUARD = """
import json, sys, time
sys.path.insert(0, {root!r})
from hcmbench import harness
from hcmbench.run import execute
from hcmbench.tests.tiny import CpuCard, tiny_cell
harness.CARD = CpuCard()
execute(tiny_cell({name!r}, precision="float32"), time.time())
print(json.dumps(harness.forbidden_loaded()))
"""


def test_no_jax_in_a_run():
    """A rehearsal in a fresh process loads no module whose top-level name
    is jax, jaxlib, flax or the JAX package (robo_vln_tpu_torch is not
    one: names are compared whole)."""
    code = GUARD.format(root=str(harness.ROOT), name=CELLS[0])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=tempfile.gettempdir())
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert harness.forbidden_loaded.__doc__ and "robo_vln_tpu_torch".split(".")[0] not in \
        harness.FORBIDDEN_MODULES


RANK_GUARD = """
import sys
sys.path.insert(0, {root!r})
from hcmbench import harness, run
from hcmbench.drivers import train
from hcmbench.tests import tiny
harness.CARD = tiny.CpuCard()
harness.require_cards = lambda n: None
harness.load_cell = lambda name, load=harness.load_cell: tiny.shrink(load(name), "float32")
train._spawned_rank = tiny.rank_loading_jax
sys.exit(run.main(["--workload", {name!r}, "--seed", "7", "--seconds", "0.3"]))
"""


@pytest.mark.parametrize("name", [c for c in TRAIN if harness.load_cell(c).mix.get("ranks", 1) > 1])
def test_jax_in_a_rank_process_ends_the_run(name):
    """On several cards the ranks are processes of their own: a module named
    jax loaded in one of them (not the one that reports) ends the run with
    code 4 and no result line."""
    code = RANK_GUARD.format(root=str(harness.ROOT), name=name)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=tempfile.gettempdir())
    assert out.returncode == 4, out.stderr[-2000:]
    assert not out.stdout.strip() and "jax" in out.stderr.splitlines()[-1]


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("robo_vln_tpu_torch", "robo_vln_tpu", "jax",
                                               "jaxlib", "flax"), (path.name, n)


@pytest.mark.parametrize("name", ONE_CARD_TRAIN)
def test_reference_holds_the_port_and_the_control_fails(name):
    """float32: the port and the reference agree to rounding; the control
    (the reference stored in float8) fails one of the cell's limits."""
    cell = tiny_cell(name, precision="float32")
    setup = train.Setup(cell, "cpu")
    got = setup.check_steps()
    ref = train.reference_readings(cell, setup)
    assert max(train.numbers(got, ref).values()) < 1e-4
    control = train.numbers(train.reference_readings(cell, setup, "float8"), ref)
    assert any(control[k] > limit for k, limit in cell.limits.items())


# -- faults ------------------------------------------------------------------------------

@pytest.mark.parametrize("name", ONE_CARD_TRAIN)
def test_fault_state_unchanged(name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    out, _ = _run(tiny_cell(name, precision="float32"))
    assert out["correct"] is False


def _half_batch(make):
    """A step builder whose step sees part of its batch: half the episodes
    (the hidden states' other rows carried as they were), or half of a
    single episode's window; the losses are the mean over that part."""
    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def part(*a):
            rows = next(x for x in a if isinstance(x, dict))["not_done_masks"].shape[0]
            if rows == 1:
                return step(*[train.part_of(x, 1) if isinstance(x, dict) else x for x in a])
            half = rows // 2
            cut = [{k: v[:half] for k, v in x.items()} if isinstance(x, dict)
                   else x[:, :half] if torch.is_tensor(x) and x.dim() == 3 else x for x in a]
            out = step(*cut)
            held = [x for x in a if torch.is_tensor(x) and x.dim() == 3]
            new = [y for y in out if torch.is_tensor(y) and y.dim() == 3]
            rest = iter(torch.cat([n, h[:, half:]], 1) for n, h in zip(new, held))
            return tuple(next(rest) if torch.is_tensor(y) and y.dim() == 3 else y for y in out)
        return part
    return wrapped


@pytest.mark.parametrize("name", ONE_CARD_TRAIN)
def test_fault_half_the_batch(name, monkeypatch):
    from robo_vln_tpu_torch.training import steps

    for maker in ("make_hier_train_step", "make_flat_train_step"):
        monkeypatch.setattr(steps, maker, _half_batch(getattr(steps, maker)))
    out, _ = _run(tiny_cell(name, precision="float32"))
    assert out["correct"] is False


FOUR_CARD = [c for c in TRAIN if harness.load_cell(c).mix.get("ranks", 1) > 1]


def _rank_without_exchange(rank, device, cell, t0, out_dir):
    """A rank of the data-parallel step whose all-reduce of gradients and
    losses is left out: each rank steps on its own rows' share."""
    from robo_vln_tpu_torch.parallel.mesh import DataMesh

    DataMesh.reduce_step = lambda self, grads, scalars: (list(grads), list(scalars))
    train._spawned_rank(rank, device, cell, t0, out_dir, CpuCard())


@pytest.mark.parametrize("name", FOUR_CARD)
def test_fault_exchange_left_out(name, tmp_path):
    from robo_vln_tpu_torch.parallel.mesh import spawn

    cell = tiny_cell(name, precision="float32")
    spawn(_rank_without_exchange, cell.mix["ranks"], "cpu", cell, time.time(), str(tmp_path),
          timeout_s=600)
    out = torch.load(tmp_path / "rank0.pt", weights_only=False)
    assert train.checks(cell, out)[1] is False


@pytest.mark.parametrize("name", EVAL)
def test_fault_answer_altered(name, monkeypatch):
    from robo_vln_tpu_torch.eval.agent import HCMAgent

    step = HCMAgent.step

    def altered(self, *args, **kwargs):
        actions, stop, hidden = step(self, *args, **kwargs)
        return actions + torch.tensor([0.25, 0.0]), stop, hidden  # a quarter of the 1 m/s drive

    monkeypatch.setattr(HCMAgent, "step", altered)
    out, _ = _run(tiny_cell(name, precision="float32"))
    assert out["correct"] is False and out["checks"]["action_gap"]["value"] > 0.2


@pytest.mark.parametrize("name", EVAL)
def test_fault_pose_unchanged(name, monkeypatch):
    from robo_vln_tpu_torch.eval import ondevice

    monkeypatch.setattr(ondevice, "integrate_rigid_state", lambda q, p, lin, ang, dt: (q, p))
    out, _ = _run(tiny_cell(name, precision="float32"))
    assert out["correct"] is False and out["checks"]["pose_gap"]["value"] > 1e-3


@pytest.mark.parametrize("name", EVAL)
def test_eval_reference_holds_the_port_and_the_control_fails(name):
    """float32: the rollout and the reference's following of it agree to
    rounding; the reference stored in float8 fails one of the cell's
    limits against the float32 one."""
    from hcmbench import calibrate

    cell = tiny_cell(name, precision="float32")
    out = calibrate.eval_readings(cell, [cell.seed], [cell.seed], "cpu")
    got = out["program"][cell.seed]
    assert got["steps_mismatch"] == 0 and got["start_gap"] == 0
    assert max(got[k] for k in ("logit_gap", "action_gap", "stop_gap", "pose_gap")) < 1e-4
    control = out["control"][cell.seed]["float8"]
    assert any(control[k] > cell.limits[k] for k in control)
