"""The rank side of tests/test_torch_mesh.py: one process a rank of a gloo
group on the CPU (parallel/mesh.spawn), each stepping the port's train and
val steps on its rows of the global windows a job file holds.  It imports
the port and torch only (no JAX), so that a rank starts in a few seconds.

A job is a list of cases, each a dict: ``kind`` ("hier" or "flat"), the
float32 policies at their starting weights (``modules``), the global
``windows`` (numpy), the step's options (``alpha``, ``inflection_coef``,
``valid_velocity_mse``), and ``counts``: "global", the
port's, or "local", each rank dividing by its own counts times the number
of ranks (the mean over ranks of per-rank means that a DDP wrapper would
give), to show that the parity checks see the difference.  Each rank saves,
per case and window, the metrics, its rows of the hidden states, every
trainable parameter's gradient and the parameters after the step, then the
val step's metrics and hidden rows on the first window.  Parameters are
the trainable ones.
"""

import copy
import time

import numpy as np
import torch

from robo_vln_tpu_torch.models import make_shared_trunk_fn
from robo_vln_tpu_torch.parallel.mesh import DataMesh
from robo_vln_tpu_torch.training import optimizers, steps

LR = 1e-4
WD = 1e-3


def _tensors(window):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in window.items()}


def _local_counts(mesh, batch, **kwargs):
    """Per-rank denominators: the rank's own counts, scaled by the ranks so
    that the sum over ranks is the mean of the ranks' own means."""
    local = steps.batch_counts(batch, **kwargs)
    scaled = {k: v * mesh.size for k, v in local.items()}
    return {**scaled, "local_elements": local["elements"]}


def _named_grads(modules):
    return {f"{level}.{n}": p.grad.clone() for level, m in modules.items()
            for n, p in m.named_parameters() if p.grad is not None}


def _params(modules):
    """The trainable parameters (the frozen ones never move: the port's
    step tests hold them; keeping them here would write the trunks' weights
    a window and rank)."""
    return {f"{level}.{n}": p.detach().clone() for level, m in modules.items()
            for mask in (optimizers.trainable_mask(m),)
            for n, p in m.named_parameters() if mask[n]}


def run_case(case, mesh):
    modules = copy.deepcopy(case["modules"])
    hier = case["kind"] == "hier"
    if hier:
        high, low = modules["high"], modules["low"]
        trunk_fn = make_shared_trunk_fn(high)
        state = steps.HierTrainState(steps.TrainState(optimizers.adamw(high, WD), 0),
                                     steps.TrainState(optimizers.adam(low, WD), 0))
        vvm = case.get("valid_velocity_mse", False)
        train = steps.make_hier_train_step(high, low, trunk_fn=trunk_fn, mesh=mesh,
                                           inflection_coef=case.get("inflection_coef"),
                                           valid_velocity_mse=vvm)
        val = steps.make_hier_val_step(high, low, trunk_fn=trunk_fn, mesh=mesh,
                                       valid_velocity_mse=vvm)
        b = case["windows"][0]["valid_mask"].shape[0] // mesh.size
        hidden = (high.initial_hidden(b), low.initial_hidden(b))
    else:
        policy = modules["policy"]
        state = steps.TrainState(optimizers.adam(policy), 0)
        train = steps.make_flat_train_step(policy, use_progress=True,
                                           progress_alpha=case["alpha"], mesh=mesh)
        val = steps.make_flat_val_step(policy, use_progress=True, progress_alpha=case["alpha"],
                                       mesh=mesh)
        b = case["windows"][0]["valid_mask"].shape[0] // mesh.size
        hidden = (policy.initial_hidden(b),)
    out = {"windows": [], "start": _params(modules)}
    for window in case["windows"]:
        batch = _tensors(mesh.shard(window))
        if hier:
            state, hh, lh, metrics = train(state, *hidden, batch, LR, LR)
            hidden = (hh, lh)
        else:
            state, h, metrics = train(state, *hidden, batch, LR)
            hidden = (h,)
        out["windows"].append({"metrics": {k: float(v) for k, v in metrics.items()},
                               "hidden": [h.clone() for h in hidden],
                               "grads": _named_grads(modules), "params": _params(modules)})
    batch = _tensors(mesh.shard(case["windows"][0]))
    if hier:
        *val_hidden, metrics = val(high.initial_hidden(b), low.initial_hidden(b), batch)
    else:
        *val_hidden, metrics = val(policy.initial_hidden(b), batch)
    out["val"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "hidden": [h.clone() for h in val_hidden]}
    return out


def rank_main(rank, device, job_path, out_dir):
    """parallel/mesh.spawn's target: every case of the job on this rank."""
    cases = torch.load(job_path, weights_only=False)
    mesh = DataMesh(device)
    results = {}
    for name, case in cases.items():
        if case.get("counts") == "local":
            saved = steps.global_counts
            steps.global_counts = lambda m, batch, **kw: _local_counts(m, batch, **kw)
            try:
                results[name] = run_case(case, mesh)
            finally:
                steps.global_counts = saved
        else:
            results[name] = run_case(case, mesh)
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _slow_value(seconds):
    time.sleep(seconds)
    return {"from": "rank 0"}


def slow_main_rank(rank, device, out_dir, seconds):
    """parallel/mesh.spawn's target: rank 0's on_main work takes
    ``seconds`` while the other ranks wait, then every rank sums a tensor
    in the step's group and meets the closing barrier."""
    mesh = DataMesh(device)
    value = mesh.on_main(_slow_value, seconds)
    total = mesh.sum(torch.ones(1))
    mesh.barrier()
    torch.save({"value": value, "sum": float(total)}, f"{out_dir}/rank{rank}.pt")
