#!/usr/bin/env python3
"""Train the PyTorch port (robo_vln_tpu_torch) over several H100 cards: one
NCCL rank a card, at the HCM's full published width.

    python3 scripts/multicard_smoke.py [n]        # n ranks, default 4

The multi-card counterpart of scripts/e2e_smoke.py (collection, the
buffer, training, a checkpoint, the closed-loop eval).  It first prints
each card's ``nvidia-smi --query-gpu=name,power.limit`` line; with fewer
visible cards than ranks it refuses before any rank starts (no gloo, no
fewer ranks, no CPU).  Then it builds the kernels (one nvcc a source) and
runs three phases; any failure, in any rank, ends the run with a non-zero
exit code and no result line.

A. Parity, float32, dropout off, on each grid ``[n, 1]``, ``[n/2, 2]`` and
   ``[1, n]`` (one spawn of n ranks runs the three in turn): weights from
   seed 0 broadcast from rank 0, the large kernels split by JAX's rule
   (parallel/mesh.shard_params at its default min_size), one train step of
   the trainers' step function (training/steps.make_hier_train_step) on
   each rank's rows of a global batch of B=4 a data rank, T=50, 200 tokens,
   then the val step on it.  Each is held to the one-process step on the
   same global batch, run in this process on ``cuda:0``: losses within
   1e-6 relative, hidden states within 1e-5, every gradient within 1e-4 of
   its leaf's norm, the parameters within tests/test_torch_mesh.py's rules
   (and the val step, on the updated weights, within that file's 1e-4);
   2 launches of ``lstm_seq``, of its backward and of ``cross_modal_attn``
   a step on every rank; the bytes of parameters and Adam state a rank
   holds against one process's.
B. ``run_exp``, bfloat16, as a user runs it (robo_vln_tpu_torch.run's
   ``--run-type train``), at the default ``TPU.MESH_SHAPE [-1, 1]``, which
   must resolve to a rank a card, and at ``[n/2, 2]``: rank 0 collects
   synthetic episodes on the kinematic backend while the others wait
   (``DAGGER.PRELOAD_LMDB_FEATURES`` false), each rank reads its rows
   through ``DAGGER.LOADER_WORKERS`` 4, one epoch with its val windows
   writes ``ckpt.2``, then a second run resumes it for ``ckpt.3``.  In the
   ranks (run_exp's own spawn, each rank's trainer timed and counted from
   outside it): 2 + 2 + 2 launches a train step and 2 + 2 a val window,
   frozen weights unchanged, each checkpoint bitwise the gathered slices
   and moments, a resumed run's slices bitwise the file's.  Each final
   checkpoint then loads into one process (every tensor as written) and
   ``eval_hierarchical_checkpoint`` over 4 synthetic episodes gives finite
   metrics; the eval uses no mesh, as in JAX.
C. What it costs over NVLink, from phase A's ranks: bf16 train steps on
   each grid, each timed by CUDA events (steps 2-4, medians), their
   all-reduce (range ``hier_train_step.all_reduce``), peak memory a card,
   beside the one-card bf16 step at B=4 in this process; and the wall time
   of each phase.  Figures, not limits.

The last line is ``{"ok": true, "cards": n, ...}`` with those figures.  Run
it on a machine with four cards; tests/test_torch_multicard.py runs phase
A's ranks with gloo on the CPU at tiny sizes.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PER_RANK_B, T, L = 4, 50, 200  # a data rank's batch, the window, the instruction
BATCH_SEED = 25
LOSS_RTOL = 1e-6  # A: losses against one process, relative
HIDDEN_TOL = 1e-5  # A: hidden states, absolute
GRAD_TOL = 1e-4  # A: each gradient's largest error, of its leaf's norm
# A: the val step runs after the train step, on weights that may part from one
# process's by 2·lr an element (Adam's step on a gradient that is rounding
# noise takes either sign): its metrics and hidden states are held, as
# tests/test_torch_mesh.py holds every step after the first, within 1e-4
VAL_TOL = 1e-4
BF16_STEPS = 4  # C: bf16 steps a grid, the first warming up
TRAIN_EPISODES = 16  # B: collected, one global batch at [n, 1]
EVAL_BUFFER_EPISODES = 4  # B: the val buffer
EVAL_EPISODES, EVAL_ENVS, EVAL_STEPS = 4, 4, 60  # B: the eval of each final checkpoint
MAX_STEPS = 150  # B: MAX_EPISODE_STEPS cut from 1000, and the one length bucket
SPAWN_TIMEOUT_S = 420  # A's spawn of the three grids
RUN_TIMEOUT_S = 300  # B: each run_exp's ranks


def grids(n):
    """Phase A's grids over n ranks: data only, a model axis of 2, model only."""
    out = [(n, 1), (n // 2, 2), (1, n)]
    return [g for i, g in enumerate(out) if g not in out[:i] and g[0] * g[1] == n]


class FullWidth:
    """Phase A's setup: the HCM at full published width (bf16 or float32
    compute), random weights from seed 0, synced trunks, dropout off;
    make_train's optimizers; a global batch of PER_RANK_B rows a data rank.
    Picklable as its options alone: each process builds the policies once a
    dtype, on the host, and hands out copies."""

    min_size = 1 << 16  # shard_params' default, JAX's
    lr = cs.TP_LR
    bf16_steps = BF16_STEPS

    def __init__(self):
        self._built = {}

    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self._built = {}

    def config(self):
        from robo_vln_tpu_torch.config import get_config

        return get_config(opts=cs.MESH_NO_DROPOUT)

    def policies(self, dtype, device):
        if dtype not in self._built:
            self._built[dtype] = cs.make_train(self.config(), dtype, "cpu")[:2]
        return tuple(copy.deepcopy(m).to(device) for m in self._built[dtype])

    def optimizers(self, high, low):
        from robo_vln_tpu_torch.training import HierTrainState, TrainState, adam, adamw

        return HierTrainState(TrainState(adamw(high, 1e-5), 0), TrainState(adam(low, 0.0), 0))

    def steps(self, high, low, mesh):
        from robo_vln_tpu_torch.models import make_shared_trunk_fn
        from robo_vln_tpu_torch.training import make_hier_val_step

        cfg = self.config()
        return cs.mesh_step(cfg, high, low, mesh), make_hier_val_step(
            high, low, trunk_fn=make_shared_trunk_fn(high),
            valid_velocity_mse=cfg.TPU.VALID_MASK_VELOCITY_MSE, mesh=mesh)

    def windows(self, data, device):
        return [cs.train_batch(torch.Generator().manual_seed(BATCH_SEED), PER_RANK_B * data,
                               T, L, device)]


# -- phases A and C: the ranks' side -------------------------------------------------

def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    """ms of a span by CUDA events on the card (and the host clock beside
    it); on the CPU the host clock alone, the events' ms NaN."""

    def __init__(self, device):
        self.device = device
        self.events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                       if device.type == "cuda" else None)

    def __enter__(self):
        self.t0 = time.perf_counter()
        if self.events:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events:
            self.events[1].record()
            self.events[1].synchronize()
            self.ms = self.events[0].elapsed_time(self.events[1])
        else:
            self.ms = float("nan")
        self.host_ms = (time.perf_counter() - self.t0) * 1e3
        return False


@contextlib.contextmanager
def _timed_reduce(times, device):
    """Each DataMesh.reduce_step's (event ms, host ms) into ``times``."""
    from robo_vln_tpu_torch.parallel.mesh import DataMesh

    original = DataMesh.reduce_step

    def reduce_step(self, grads, scalars):
        with _Timer(device) as timer:
            out = original(self, grads, scalars)
        times.append((timer.ms, timer.host_ms))
        return out

    DataMesh.reduce_step = reduce_step
    try:
        yield
    finally:
        DataMesh.reduce_step = original


def _reset_launches():
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm

    fused_lstm.reset_launches()
    fused_attention.reset_launches()


def _split(setup, mesh, *modules):
    """Each policy's kernels split over the model axis by JAX's rule at the
    setup's min_size; the count split."""
    from robo_vln_tpu_torch.parallel.mesh import shard_params

    return sum(dim is not None for m in modules
               for dim in shard_params(m, mesh, setup.min_size).values())


def _gathered(modules, fn):
    """{level.name: fn(p)} over the trainable parameters, each split one
    gathered whole (every rank of its model group takes part, in module
    order), as copies on the host."""
    return {k: v.clone() for k, v in cs._trainable(modules, fn, gather=True).items()}


def _agree(modules, mesh):
    """Whether the whole weights equal the first rank's of the model group
    and the slices the first rank's of the data group."""
    from robo_vln_tpu_torch.parallel import tensor

    local = torch.cat([p.detach().float().reshape(-1) for m in modules for p in m.parameters()])
    whole = torch.cat([p.detach().float().reshape(-1) for m in modules
                       for p in tensor.whole_copy(m).parameters()])
    out = True
    for flat, group in ((local, mesh.data_group), (whole, mesh.model_group)):
        ref = flat.clone()
        group.broadcast(ref)
        out = out and torch.equal(flat, ref)
    return out


def float32_step(setup, mesh, device, data=None):
    """Phase A on one rank of ``mesh`` (or, with a mesh of one rank, the
    one-process reference; ``data``: the grid's data ranks, whose count
    sets the global batch): the float32 train step on each window (the
    metrics, this rank's rows of the hidden states, every trainable
    gradient and parameter gathered whole, the launches), then the val step
    on the first window; the bytes of parameters and Adam state held."""
    high, low = setup.policies(torch.float32, device)
    mesh.broadcast(high, low)
    out = {"place": (mesh.rank, mesh.model_rank), "split": _split(setup, mesh, high, low),
           "windows": []}
    state = setup.optimizers(high, low)
    train, val = setup.steps(high, low, mesh)
    windows = setup.windows(data or mesh.size, device)
    b = windows[0]["valid_mask"].shape[0] // mesh.size
    hidden = (high.initial_hidden(b, device), low.initial_hidden(b, device))
    modules = {"high": high, "low": low}
    for window in windows:
        _reset_launches()
        state, hh, lh, metrics = train(state, *hidden, mesh.shard(window), setup.lr, setup.lr)
        hidden = (hh, lh)
        out["windows"].append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "hidden": [h.detach().cpu().clone() for h in hidden],
            "grads": _gathered(modules, lambda p: p.grad),
            "params": _gathered(modules, lambda p: p),
            "launches": cs.path_launches()})
    _reset_launches()
    *val_hidden, metrics = val(high.initial_hidden(b, device), low.initial_hidden(b, device),
                               mesh.shard(windows[0]))
    out["val"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "hidden": [h.detach().cpu().clone() for h in val_hidden],
                  "launches": cs.path_launches()}
    out["bytes"] = cs.held_bytes((high, low), (state.high.optimizer, state.low.optimizer))
    del high, low, state, train, val, modules
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def bf16_steps(setup, mesh, device, data=None):
    """Phase C on one rank: ``setup.bf16_steps`` bf16 train steps on the
    first window, each timed (CUDA events and the host clock), their
    all-reduces timed, the launches, the peak memory of the card, whether
    the ranks' weights agree after the steps."""
    high, low = setup.policies(torch.bfloat16, device)
    mesh.broadcast(high, low)
    _split(setup, mesh, high, low)
    state = setup.optimizers(high, low)
    train, _ = setup.steps(high, low, mesh)
    window = mesh.shard(setup.windows(data or mesh.size, device)[0])
    b = window["valid_mask"].shape[0]
    hh, lh = high.initial_hidden(b, device), low.initial_hidden(b, device)
    step_ms, reduce_ms, losses = [], [], []
    _synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    with _timed_reduce(reduce_ms, device):
        for _ in range(setup.bf16_steps):
            with _Timer(device) as timer:
                state, hh, lh, metrics = train(state, hh, lh, window, setup.lr, setup.lr)
            step_ms.append((timer.ms, timer.host_ms))
            losses.append({k: float(v) for k, v in metrics.items()})
    out = {"step_ms": step_ms, "reduce_ms": reduce_ms, "losses": losses,
           "launches": cs.path_launches(), "steps": setup.bf16_steps,
           "peak_bytes": (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                          else 0),
           "weights_agree": _agree((high, low), mesh)}
    del high, low, state, train
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def step_rank(rank, device, setup, grid_list, out_dir):
    """Phases A and C on one rank, spawned by parallel/mesh.spawn: on each
    grid of ``grid_list`` in turn (each a mesh of the one process group),
    the float32 parity step, then the timed bf16 steps; the results into
    ``out_dir``/rank{rank}.pt."""
    from robo_vln_tpu_torch.parallel.mesh import DataMesh

    out = {}
    for d, m in grid_list:
        mesh = DataMesh(device, size=d, model=m)
        t0 = time.perf_counter()
        out[(d, m)] = {"float32": float32_step(setup, mesh, device),
                       "bfloat16": bf16_steps(setup, mesh, device) if setup.bf16_steps else None}
        out[(d, m)]["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# -- phase A: the parent's side ------------------------------------------------------

def hold_val(label, got, ref, tol=VAL_TOL):
    """The val step's metrics, absolute (the accuracy among them)."""
    key = max(ref, key=lambda k: abs(got[k] - ref[k]))
    err = abs(got[key] - ref[key])
    print(f"  {label}: metrics within {err:.3e}, at {key} (tolerance {tol})")
    if not err <= tol:
        cs.fail(f"{label}: {key} parts from one process's")


def hold_hidden(label, got, ref, data_rank, n_data, tol=HIDDEN_TOL):
    errs = []
    for h, want in zip(got, ref):
        b = want.shape[-2] // n_data
        errs.append((h.float() - want[..., data_rank * b:(data_rank + 1) * b, :]).abs().max()
                    .item())
    print(f"  {label}: hidden states (high, low) within {errs[0]:.3e}, {errs[1]:.3e} of one "
          f"process's rows (tolerance {tol})")
    if not max(errs) <= tol:
        cs.fail(f"{label}: a hidden state parts from one process's")


def check_launches(label, launches, steps, backward=True):
    got = {k: launches[k] for k in ("lstm_seq", "lstm_seq_backward", "cross_modal_attn")}
    want = {"lstm_seq": 2 * steps, "lstm_seq_backward": 2 * steps if backward else 0,
            "cross_modal_attn": 2 * steps}
    if got != want:
        cs.fail(f"{label} launched {launches}, expected {want}")


def hold_rank(label, rank_out, ref, n_data):
    """One rank's float32 step and val step against one process's."""
    data_rank = rank_out["place"][0]
    for w, (got, want) in enumerate(zip(rank_out["windows"], ref["windows"])):
        cs.hold_step_to_plain(f"{label}, window {w}", got["metrics"], got["grads"],
                              want["metrics"], want["grads"], against="one process's step",
                              loss_rtol=LOSS_RTOL, grad_tol=GRAD_TOL)
        hold_hidden(f"{label}, window {w}", got["hidden"], want["hidden"], data_rank, n_data)
        cs.hold_params_to_one_process(f"{label}, window {w}", got["params"], want["params"],
                                      want["grads"], cs.TP_LR, w + 1)
        check_launches(f"{label}'s step", got["launches"], 1)
    hold_val(f"{label}, val step after it", rank_out["val"]["metrics"], ref["val"]["metrics"])
    hold_hidden(f"{label}, val step after it", rank_out["val"]["hidden"], ref["val"]["hidden"],
                data_rank, n_data, VAL_TOL)
    check_launches(f"{label}'s val step", rank_out["val"]["launches"], 1, backward=False)


def _median_ms(pairs, first=1):
    """The median of the events' ms of steps ``first``+1 on (steps 2-4)."""
    return statistics.median(e for e, _ in pairs[first:])


def steps_path(n, device, setup):
    """Phases A and C: the one-process references in this process, then n
    ranks over every grid."""
    from robo_vln_tpu_torch.parallel.mesh import DataMesh, spawn

    grid_list = grids(n)
    print(f"phase A: parity, float32, dropout off, B={PER_RANK_B} a data rank, T={T}, {L} "
          f"tokens, lr {setup.lr}; grids {[list(g) for g in grid_list]} over {n} NCCL ranks, "
          f"one a card")
    t0 = time.perf_counter()
    one = DataMesh(device)
    refs = {}
    for d in sorted({d for d, _ in grid_list}):
        refs[d] = float32_step(setup, one, device, data=d)
        check_launches(f"the one-process step at B={PER_RANK_B * d}",
                       refs[d]["windows"][0]["launches"], 1)
    one_card = bf16_steps(setup, one, device, data=1)
    print(f"  one-process references (float32 at global batches "
          f"{[PER_RANK_B * d for d in refs]}, bf16 at B={PER_RANK_B}) on {device} in "
          f"{time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="multicard_", dir=_scratch())
    try:
        t1 = time.perf_counter()
        spawn(step_rank, n, device.type, setup, grid_list, root, timeout_s=SPAWN_TIMEOUT_S)
        spawn_s = time.perf_counter() - t1
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(n)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  {n} ranks spawned, ran the {len(grid_list)} grids and joined in {spawn_s:.1f} s")
    one_bytes = refs[min(refs)]["bytes"]
    summary = {"bytes": {}, "split": {}}
    for (d, m) in grid_list:
        print(f"  [{d}, {m}]: global batch {PER_RANK_B * d}")
        for rank in range(n):
            res = ranks[rank][(d, m)]["float32"]
            label = f"[{d}, {m}] rank {rank} (data {res['place'][0]}, model {res['place'][1]})"
            hold_rank(label, res, refs[d], d)
        held = [ranks[r][(d, m)]["float32"]["bytes"] for r in range(n)]
        split = ranks[0][(d, m)]["float32"]["split"]
        summary["bytes"][f"{d}x{m}"] = max(held) / one_bytes
        summary["split"][f"{d}x{m}"] = split
        print(f"  [{d}, {m}]: {split} tensors split; parameters and Adam state a rank, bytes: "
              f"{held} against one process's {one_bytes} ({max(held) / one_bytes:.4f}); "
              f"the grid in {max(ranks[r][(d, m)]['seconds'] for r in range(n)):.1f} s a rank")
    phase_a_s = time.perf_counter() - t0
    print(f"phase A passed in {phase_a_s:.1f} s (the references, the spawn, both dtypes)")

    print(f"phase C: bf16 steps over NVLink, {setup.bf16_steps} a grid (steps 2-"
          f"{setup.bf16_steps} timed by CUDA events, medians), B={PER_RANK_B} a data rank")
    one_ms = _median_ms(one_card["step_ms"])
    print(f"  one card, one process, B={PER_RANK_B} (phase 5's step): step "
          + " ".join(f"{e:.3f}/{h:.3f}" for e, h in one_card["step_ms"])
          + f" ms (events/host), median {one_ms:.3f}; peak "
          f"{one_card['peak_bytes'] / 2**30:.3f} GiB")
    check_launches("the one-card bf16 steps", one_card["launches"], setup.bf16_steps)
    costs = {"one_card_step_ms": one_ms, "step_ms": {}, "all_reduce_ms": {}, "peak_gib": {}}
    for (d, m) in grid_list:
        medians, reduces, peaks = [], [], []
        for rank in range(n):
            res = ranks[rank][(d, m)]["bfloat16"]
            check_launches(f"[{d}, {m}] rank {rank}'s bf16 steps", res["launches"],
                           res["steps"])
            if not all(math.isfinite(v) for step in res["losses"] for v in step.values()):
                cs.fail(f"[{d}, {m}] rank {rank}: a bf16 step gave a non-finite metric")
            if not res["weights_agree"]:
                cs.fail(f"[{d}, {m}] rank {rank}: the weights part from its groups' first "
                        "ranks' after the bf16 steps")
            medians.append(_median_ms(res["step_ms"]))
            if res["reduce_ms"]:
                reduces.append(_median_ms(res["reduce_ms"]))
            peaks.append(res["peak_bytes"] / 2**30)
            print(f"  [{d}, {m}] rank {rank}: step " + " ".join(
                f"{e:.3f}/{h:.3f}" for e, h in res["step_ms"]) + " ms; all-reduce " + " ".join(
                f"{e:.3f}/{h:.3f}" for e, h in res["reduce_ms"]) + f" ms; peak {peaks[-1]:.3f} GiB")
        key = f"{d}x{m}"
        costs["step_ms"][key] = max(medians)
        costs["all_reduce_ms"][key] = max(reduces) if d > 1 else None
        costs["peak_gib"][key] = max(peaks)
        what = "the step" if m == 1 else "the split step"
        print(f"  [{d}, {m}]: {what} {max(medians):.3f} ms (the slowest rank's median; "
              f"{max(medians) / one_ms:.3f}x the one-card step), reduce_step over the data "
              + (f"axis {max(reduces):.3f} ms" if d > 1 else
                 f"axis of one rank (its buffer's copy alone) {max(reduces):.3f} ms")
              + f", peak {max(peaks):.3f} GiB a card")
    summary["phase_a_s"] = phase_a_s
    return summary, costs


# -- phase B: run_exp over the cards -------------------------------------------------

def _scratch():
    from robo_vln_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    return str(_build.BUILD_DIR.parent)


@contextlib.contextmanager
def checked_resume(saved_path, checks):
    """Around a resumed run in a rank: right after the trainer splits its
    policies, every tensor and moment is its slice of ``saved_path``'s
    (chip_smoke.restored_as_saved); what it compared into ``checks``."""
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer as HT

    if saved_path is None:
        yield
        return
    saved = torch.load(os.path.join(saved_path, ckpt_lib.TRAIN_STATE), map_location="cpu",
                       weights_only=True)
    original = HT._shard_policies

    def shard_policies(self):
        original(self)
        checks.append(cs.restored_as_saved(self, saved))

    HT._shard_policies = shard_policies
    try:
        yield
    finally:
        HT._shard_policies = original


@contextlib.contextmanager
def timed_on_main(times):
    """The host ms of each DataMesh.on_main call (rank 0's work, the
    others' wait)."""
    from robo_vln_tpu_torch.parallel.mesh import DataMesh

    original = DataMesh.on_main

    def on_main(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = original(self, fn, *args, **kwargs)
        times.append((getattr(fn, "__name__", str(fn)), (time.perf_counter() - t0) * 1e3))
        return out

    DataMesh.on_main = on_main
    try:
        yield
    finally:
        DataMesh.on_main = original


def instrumented_rank(rank, device, fn, record_dir, resume_from, *args):
    """A rank of run_exp's spawn (``fn``: run._train_rank) with its trainer
    timed and counted from outside it (chip_smoke.instrumented_trainer: 2 +
    2 + 2 launches a train step, 2 + 2 a val window, or a failure), then
    its checkpoint held to its gathered slices and moments and its frozen
    weights to the first ones; its record into ``record_dir``."""
    from robo_vln_tpu_torch.parallel import tensor

    record, restored, waits = cs.new_trainer_record(), [], []
    _reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with cs.instrumented_trainer(record), checked_resume(resume_from, restored), \
            timed_on_main(waits):
        fn(rank, device, *args)
    seconds = time.perf_counter() - t0
    launches = cs.path_launches()
    (trainer,) = record["trainers"]
    # the split tensors gathered whole, in module order on every rank
    whole = {level: tensor.whole_state_dict(getattr(trainer, level)) for level in ("high", "low")}
    for (level, name), p in record["frozen"].items():
        if not torch.equal(whole[level][name], p):
            cs.fail(f"rank {rank}: the frozen {level} {name} moved")
    checkpoint = cs.checkpoint_as_gathered(trainer, whole)
    mesh = trainer.mesh
    out = {"mesh": (mesh.size, mesh.model_size, torch.distributed.get_backend()),
           "place": (mesh.rank, mesh.model_rank), "seconds": seconds, "launches": launches,
           "checkpoint": checkpoint, "restored": restored, "on_main": waits,
           "frozen": len(record["frozen"]),
           "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
           **{k: record[k] for k in ("train_ms", "train_event_ms", "val_ms", "val_event_ms",
                                     "gaps_ms", "epoch_ms", "val_epoch_ms", "save_ms",
                                     "first_wait_ms", "first_steps")}}
    torch.save(out, os.path.join(record_dir, f"rank{rank}.pt"))


@contextlib.contextmanager
def instrumented_spawn(record_dir, resume_from, spawned):
    """run_exp's ranks as instrumented_rank, each run bounded by
    RUN_TIMEOUT_S; the (ranks, device) of each spawn into ``spawned``."""
    from robo_vln_tpu_torch.parallel import mesh as mesh_lib

    original = mesh_lib.spawn

    def spawn(fn, size, device, *args, **kwargs):
        spawned.append((size, str(device)))
        kwargs.setdefault("timeout_s", RUN_TIMEOUT_S)
        return original(instrumented_rank, size, device, fn, record_dir, resume_from, *args,
                        **kwargs)

    mesh_lib.spawn = spawn
    try:
        yield
    finally:
        mesh_lib.spawn = original


def run_opts(device, root, tag, data, shape, model_opts=()):
    return ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer",
            "TPU.MESH_SHAPE", shape, "TPU.PRECISION", "bfloat16",
            "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "MODEL.INSTRUCTION_ENCODER.is_bert", True,
            "DAGGER.PRELOAD_LMDB_FEATURES", False, "DAGGER.UPDATE_SIZE", TRAIN_EPISODES,
            "DAGGER.ITERATIONS", 1, "DAGGER.EPOCHS", 2, "DAGGER.MAX_EPOCHS_PER_RUN", 1,
            "DAGGER.RESUME", True, "DAGGER.BATCH_SIZE", PER_RANK_B, "DAGGER.tbptt_steps", T,
            "DAGGER.EPISODE_LEN_BUCKETS", [MAX_STEPS], "DAGGER.LOADER_WORKERS", 4,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", MAX_STEPS, "NUM_PROCESSES", 1,
            "TASK_CONFIG.SIMULATOR.TYPE", "kinematic", "TASK_CONFIG.DATASET.DATA_PATH", data,
            "DAGGER.LMDB_FEATURES_DIR", os.path.join(root, f"buffer_{tag}"),
            "DAGGER.LMDB_EVAL_DIR", os.path.join(root, "eval"),
            "CHECKPOINT_FOLDER", os.path.join(root, f"ckpts_{tag}"),
            "TENSORBOARD_DIR", os.path.join(root, f"tb_{tag}"),
            "LOG_FILE", os.path.join(root, f"train_{tag}.log"), *model_opts]


def eval_opts(device, root, tag, data, ckpt, model_opts=()):
    return ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer",
            "EVAL_CKPT_PATH_DIR", ckpt, "TENSORBOARD_DIR", os.path.join(root, f"tb_eval_{tag}"),
            "LOG_FILE", os.path.join(root, f"eval_{tag}.log"),
            "TASK_CONFIG.SIMULATOR.TYPE", "kinematic", "TASK_CONFIG.DATASET.DATA_PATH", data,
            "TASK_CONFIG.TASK.NDTW.GT_PATH", os.path.join(root, "no_gt.json.gz"),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", EVAL_STEPS,
            "EVAL.EPISODE_COUNT", EVAL_EPISODES, "EVAL.NUM_ENVS", EVAL_ENVS,
            "EVAL.VAL_LOG_DIR", os.path.join(root, f"val_{tag}"),
            "MODEL.INSTRUCTION_ENCODER.is_bert", True, "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True,
            "TPU.PRECISION", "bfloat16", *model_opts]


@contextlib.contextmanager
def loads_as_written(ckpt, loaded):
    """Around an eval: the weights the eval loads are the file's, every
    tensor bitwise; the count compared into ``loaded``."""
    from robo_vln_tpu_torch.eval import evaluator
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib

    original = evaluator._load_eval_weights
    file = torch.load(os.path.join(ckpt, ckpt_lib.TRAIN_STATE), map_location="cpu",
                      weights_only=True)

    def load(trainer, path):
        out = original(trainer, path)
        for level in ("high", "low"):
            for k, v in getattr(trainer, level).state_dict().items():
                if not torch.equal(v.cpu(), file[f"{level}_level_state_dict"][k]):
                    cs.fail(f"{ckpt} loads into one process with {level} {k} changed")
                loaded.append(k)
        return out

    evaluator._load_eval_weights = load
    try:
        yield
    finally:
        evaluator._load_eval_weights = original


def _rank_records(record_dir, n):
    out = [torch.load(os.path.join(record_dir, f"rank{r}.pt"), weights_only=False)
           for r in range(n)]
    shutil.rmtree(record_dir)
    return out


def trainer_runs(n, device, model_opts=(), vocab=30522, px=(224, 256)):
    """Phase B: run_exp's train at [-1, 1] and [n/2, 2], each an epoch and a
    resumed one, then each final checkpoint's eval in this process.
    ``model_opts``, ``vocab`` and ``px`` shrink it for a rehearsal on the
    CPU (where -1 is one process: the data axis is then given as n)."""
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib

    cuda = device.type == "cuda"
    shapes = {"default": [-1, 1] if cuda else [n, 1], "model": [n // 2, 2]}
    print(f"phase B: run_exp's train, bfloat16, at TPU.MESH_SHAPE {shapes['default']} (a rank "
          f"a card) and {shapes['model']}: rank 0 collects {TRAIN_EPISODES} synthetic episodes "
          f"(kinematic, MAX_EPISODE_STEPS {MAX_STEPS}) while the others wait, "
          f"DAGGER.LOADER_WORKERS 4, BATCH_SIZE {PER_RANK_B} a data rank, an epoch with its val "
          f"windows ({EVAL_BUFFER_EPISODES} episodes), then a run resuming it")
    root = tempfile.mkdtemp(prefix="multicard_trainer_", dir=_scratch())
    try:
        t0 = time.perf_counter()
        data = os.path.join(root, "episodes.json.gz")
        cs.write_eval_episodes(data, TRAIN_EPISODES, vocab=vocab)
        cs.write_trainer_buffers(root, (0, EVAL_BUFFER_EPISODES), vocab=vocab, rgb_px=px[0],
                                 depth_px=px[1])
        print(f"  {TRAIN_EPISODES} episodes and the val buffer written in "
              f"{time.perf_counter() - t0:.1f} s")
        summary = {}
        for tag, shape in shapes.items():
            opts = run_opts(device.type, root, tag, data, shape, model_opts)
            folder = os.path.join(root, f"ckpts_{tag}")
            runs = []
            for resume in (False, True):
                record_dir = os.path.join(root, f"records_{tag}_{int(resume)}")
                os.makedirs(record_dir)
                spawned = []
                saved = ckpt_lib.list_checkpoints(folder)[-1] if resume else None
                t1 = time.perf_counter()
                with instrumented_spawn(record_dir, saved, spawned):
                    run_exp(None, "train", opts)
                run_s = time.perf_counter() - t1
                if [s for s, _ in spawned] != [n]:
                    cs.fail(f"run_exp at TPU.MESH_SHAPE {shape} spawned {spawned}, expected "
                            f"{n} ranks")
                ranks = _rank_records(record_dir, n)
                runs.append(report_run(tag, shape, resume, ranks, run_s, n))
            names = [os.path.basename(c) for c in ckpt_lib.list_checkpoints(folder)]
            if names != ["ckpt.2", "ckpt.3"]:
                cs.fail(f"TPU.MESH_SHAPE {shape}: checkpoints {names}, expected ckpt.2, ckpt.3")
            summary[tag] = {"runs": runs,
                            "eval": evaluate(device, root, tag, data,
                                             os.path.join(folder, "ckpt.3"), model_opts)}
        summary["phase_b_s"] = time.perf_counter() - t0
        print(f"phase B passed in {summary['phase_b_s']:.1f} s")
        return summary
    finally:
        shutil.rmtree(root, ignore_errors=True)


def report_run(tag, shape, resume, ranks, run_s, n):
    """Check and print one run_exp run's rank records."""
    what = "resumed run" if resume else "first run"
    mesh = ranks[0]["mesh"]
    if any(r["mesh"] != mesh for r in ranks) or mesh[0] * mesh[1] != n:
        cs.fail(f"TPU.MESH_SHAPE {shape}: the ranks joined {[r['mesh'] for r in ranks]}")
    steps = len(ranks[0]["train_ms"])
    val = len(ranks[0]["val_ms"])
    want = cs.trainer_launches(steps, val)
    print(f"  {shape}, {what}: {n} ranks, a {mesh[0]} x {mesh[1]} grid ({mesh[2]}), in "
          f"{run_s:.1f} s (spawn to join); {steps} train steps and {val} val windows a rank")
    for rank, r in enumerate(ranks):
        if len(r["train_ms"]) != steps or len(r["val_ms"]) != val:
            cs.fail(f"{shape} rank {rank}: {len(r['train_ms'])} steps, {len(r['val_ms'])} val "
                    f"windows; rank 0 {steps}, {val}")
        if r["launches"] != want:
            cs.fail(f"{shape} rank {rank}'s {what} launched {r['launches']}, expected {want}")
        if resume and not r["restored"]:
            cs.fail(f"{shape} rank {rank}: the resumed run checked no restored slice")
        name, compared = r["checkpoint"]
        waits = ", ".join(f"{fn} {ms:.1f}" for fn, ms in r["on_main"])
        print(f"    rank {rank} (data {r['place'][0]}, model {r['place'][1]}): steps "
              + " ".join(f"{e:.3f}" for e in r["train_event_ms"]) + " ms (events; host "
              + " ".join(f"{h:.3f}" for h in r["train_ms"]) + "), val windows "
              + " ".join(f"{e:.3f}" for e in r["val_event_ms"]) + " ms; epoch "
              + " ".join(f"{t:.1f}" for t in r["epoch_ms"]) + " ms, save "
              + " ".join(f"{t:.1f}" for t in r["save_ms"]) + f" ms; on_main (ms): {waits}; "
              f"{name}: {compared} tensors bitwise the gathered slices and moments"
              + (f"; restored bitwise as the file's slices (optimizer entries, split "
                 f"tensors): {r['restored'][0]}"
                 if resume else "")
              + f"; {r['frozen']} frozen tensors unchanged; peak {r['peak_bytes'] / 2**30:.3f} "
              f"GiB; {r['seconds']:.1f} s in the rank")
    print(f"    launches a rank: {want} (2 + 2 forward and 2 LSTM backward a step, 2 + 2 a "
          "val window)")
    return {"mesh": list(mesh[:2]), "steps": steps, "val_windows": val, "seconds": run_s,
            "step_ms": [r["train_event_ms"] for r in ranks],
            "peak_gib": max(r["peak_bytes"] for r in ranks) / 2**30}


def evaluate(device, root, tag, data, ckpt, model_opts=()):
    """The final checkpoint in one process: loaded as written, then the
    closed-loop eval with finite metrics."""
    from robo_vln_tpu_torch.run import run_exp

    loaded = []
    t0 = time.perf_counter()
    with loads_as_written(ckpt, loaded):
        run_exp(None, "eval", eval_opts(device, root, tag, data, ckpt, model_opts))
    seconds = time.perf_counter() - t0
    path = os.path.join(root, f"val_{tag}", "stats_ckpt_0_val_seen.json")
    if not os.path.exists(path):
        cs.fail(f"the eval of {ckpt} wrote no {path}")
    with open(path) as f:
        stats = json.load(f)
    for key in cs.EVAL_STATS:
        if not math.isfinite(stats.get(key, float("nan"))):
            cs.fail(f"the eval of {ckpt}: {key} = {stats.get(key)!r}, not finite")
    if not loaded:
        cs.fail(f"the eval of {ckpt} loaded no weights")
    print(f"  {tag}'s ckpt.3 in one process: {len(loaded)} tensors loaded as written; "
          f"{EVAL_EPISODES} episodes at EVAL.NUM_ENVS {EVAL_ENVS}, MAX_EPISODE_STEPS {EVAL_STEPS}"
          f", in {seconds:.1f} s: " + ", ".join(f"{k} {stats[k]:.4f}" for k in cs.EVAL_STATS))
    return {k: stats[k] for k in cs.EVAL_STATS}


# -- the entry point ------------------------------------------------------------------

def require_cards(n):
    """n ranks need n visible cards: fewer raise before any rank starts."""
    from robo_vln_tpu_torch.parallel import mesh as mesh_lib

    if not torch.cuda.is_available():
        raise RuntimeError("multicard_smoke: no CUDA device")
    visible = mesh_lib.visible_devices("cuda")
    if visible < n:
        raise RuntimeError(f"multicard_smoke: {n} ranks put one on each card and {visible} "
                           "CUDA devices are visible; it runs on no fewer cards, on gloo or "
                           "on the CPU")
    return visible


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 4
    if n < 2 or n % 2:
        raise ValueError(f"multicard_smoke: {n} ranks; it needs an even count of at least 2")
    t_start = time.perf_counter()
    visible = require_cards(n)
    cards = cs.card_lines()
    for i, line in enumerate(cards):
        print(f"card {i}: {line}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, {visible} device(s); /dev/shm "
          f"{shutil.disk_usage('/dev/shm').free / 2**30:.1f} GiB free")
    if visible != n:
        raise RuntimeError(f"multicard_smoke: {visible} cards are visible and {n} ranks asked "
                           "for: TPU.MESH_SHAPE [-1, 1] would put a rank on each card")
    from robo_vln_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(logs) or 'nothing (up to date)'} in {build_s:.1f} s")
    device = torch.device("cuda", 0)
    phase_a, costs = steps_path(n, device, FullWidth())
    phase_b = trainer_runs(n, device)
    total = time.perf_counter() - t_start
    print(f"wall time: build {build_s:.1f} s, phases A and C {phase_a['phase_a_s']:.1f} s, "
          f"phase B {phase_b['phase_b_s']:.1f} s, in all {total:.1f} s")
    name, limit = cards[0].split(", ")
    print(json.dumps({"ok": True, "cards": n, "kind": name, "power_limit": limit,
                      "seconds": {"build": build_s, "a_and_c": phase_a["phase_a_s"],
                                  "b": phase_b["phase_b_s"], "all": total},
                      "bytes_of_one_process": phase_a["bytes"], "split": phase_a["split"],
                      **costs,
                      "run_exp": {tag: [r["steps"] for r in phase_b[tag]["runs"]]
                                  for tag in ("default", "model")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
