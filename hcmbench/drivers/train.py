"""The train-step driver: a closed loop of the configuration's train step
over a pool of batches made on the card from the seed, the hidden states
carried from window to window as TBPTT carries them.

Set-up (``setup_s``, from the harness's first statement to the first timed
step): the port's config, the weights and the batch pool drawn on the card,
the program built over them, then the check steps and the warm-up steps,
which run every shape the window runs.  The first ``CHECK_STEPS`` steps go
through the window's own call on the pool's first batches (rows that all
differ); the program's losses, its first gradient (read from its optimizers'
first moments after one step) and the change of its parameters after them
are kept for the comparison that decides ``correct``.

The window (``--trace 0``): steps back to back for ``--seconds``; each
step's return is stamped by a CUDA event on the step's stream, the window
by the host's clock around it (it ends in a synchronisation).  A traced run
(``--trace 1``) instead times ``trace_steps`` steps untraced (the window
that ``mfu`` divides by), then profiles as many twice (hcmbench/trace.py):
the card alone, then host and card.  Where the mix sets ``trace_window``, a
window as above runs first, its step intervals kept as ``window_step_ms``.

After the window the memory peak is read, the program freed, and the
reference follows the check steps in float32 on the same batches and
weights.  On several cards every rank runs the step on its rows of each
global batch; rank 0 times the window, decides when it closes, traces, and
holds the reference step on the whole global batch.
"""

from __future__ import annotations

import math
import os
import statistics
import tempfile
import time

import torch

from .. import harness
from ..weights import generator, make_weights

CHECK_STEPS = 3
BETA1 = 0.9


class Setup:
    """The program and its inputs on one rank."""

    def __init__(self, cell, device, mesh=None, rank=0, ranks=1, keep_global=True,
                 build_program=True):
        fam = self.fam = harness.family(cell)
        self.cell, self.device, self.rank, self.ranks = cell, device, rank, ranks
        mix, config = cell.mix, cell.config
        self.cfg = fam.port_config(config, torch.device(device).type)
        self.weights = fam.tie(make_weights(fam.weight_shapes(self.cfg), cell.seed, device))
        gen = generator(cell.seed + 1, device)
        rows = mix["batch"]
        self.pool, self.global_batches = [], []
        for i in range(mix["pool"]):
            whole = fam.make_batch(gen, mix, self.cfg, device, rows * ranks)
            self.pool.append({k: v[rank * rows:(rank + 1) * rows].contiguous()
                              for k, v in whole.items()})
            if keep_global and i < CHECK_STEPS:
                self.global_batches.append(whole)
        self.program = None
        if build_program:
            self.program = fam.Program(config, self.cfg, self.weights, device, mesh)
            self.names = dict((id(p), n) for n, p in self.program.named_parameters())
        self.steps = 0
        self.losses = []

    def batch(self):
        return self.pool[self.steps % len(self.pool)]

    def step(self):
        out = self.program.run(self.batch())
        self.steps += 1
        return out

    def check_steps(self):
        """The program's readings over the first steps: {"losses": [{key:
        float}], "grads": {leaf: norm}, "change": {leaf: norm}}."""
        readings = {"losses": []}
        for i in range(CHECK_STEPS):
            out = self.step()
            readings["losses"].append({k: float(v) for k, v in out.items()})
            if i == 0:
                readings["grads"] = self.first_gradient_norms()
        readings["change"] = self.change_norms()
        return readings

    @torch.no_grad()
    def first_gradient_norms(self):
        """Each trained leaf's first gradient, as its optimizer holds it
        after one step (the first moment over 1 - beta1)."""
        out = {}
        for opt in self.program.optimizers().values():
            for group in opt.param_groups:
                for p in group["params"]:
                    st = opt.state.get(p)
                    if st and "exp_avg" in st:
                        out[self.names[id(p)]] = float((st["exp_avg"] / (1 - BETA1)).norm())
        return out

    @torch.no_grad()
    def change_norms(self):
        return {n: float((p - self.weights[n]).norm())
                for n, p in self.program.named_parameters() if n in self.weights}


def part_of(batch, rows):
    """The first ``rows`` episodes of a batch or, of a batch of one episode,
    the first half of its window: part of the batch left out."""
    if batch["not_done_masks"].shape[0] > 1:
        return {k: v[:rows] for k, v in batch.items()}
    half = batch["not_done_masks"].shape[1] // 2
    return {k: v if k == "instruction" else v[:, :half] for k, v in batch.items()}


def reference_readings(cell, setup_or_inputs, precision="float32", rows=None):
    """The reference's readings on the check steps' global batches: the
    same keys as :meth:`Setup.check_steps`.  ``rows``: only part of each
    batch (:func:`part_of`; a fault: part of the batch left out)."""
    fam = harness.family(cell)
    weights, batches, cfg = (setup_or_inputs.weights, setup_or_inputs.global_batches,
                             setup_or_inputs.cfg)
    ref = fam.Reference(weights, fam.reference_sizes(cell.config, cfg), precision,
                        fam.dropout_seed)
    ranks = 1 if rows is not None else cell.mix.get("ranks", 1)
    readings = {"losses": []}
    for i, batch in enumerate(batches):
        if rows is not None:
            batch = part_of(batch, rows)
        terms, grads = fam.reference_step(ref, batch, cell.config, ranks=ranks)
        readings["losses"].append({k: float(v) for k, v in terms.items()})
        if i == 0:
            readings["grads"] = {k: float(g.norm()) for k, g in grads.items()}
    readings["change"] = {k: float((v - weights[k].float()).norm()) for k, v in ref.params.items()}
    return readings


def _gaps(got, ref):
    """Each compared quantity's relative gaps: loss terms by step, first
    gradients and changes by leaf (see :func:`numbers`)."""
    losses = [[abs(g[k] - r[k]) / max(abs(r[k]), 1e-12) for k in r]
              for g, r in zip(got["losses"], ref["losses"])]
    rg = ref["grads"]
    med_g = statistics.median(rg.values())
    grads = {k: abs(got["grads"].get(k, 0.0) - v) / max(v, med_g) for k, v in rg.items()}
    moved = [k for k, v in rg.items() if v >= 1e-3 * med_g]
    rc = ref["change"]
    med_c = statistics.median(rc[k] for k in moved)
    change = {k: abs(got["change"].get(k, 0.0) - rc[k]) / max(rc[k], med_c) for k in moved}
    return losses, grads, change


def numbers(got, ref):
    """The numbers that can be compared, from the program's readings
    against the reference's.  Loss terms: the gap relative to the
    reference's term; ``loss_gap.first``, the worst term of the first step,
    ``loss_gap``, the worst of any step.  Gradients: each leaf's first
    gradient, the gap between the program's norm and the reference's over
    the larger of the reference leaf's norm and the median leaf's;
    ``grad_gap``, the worst leaf, ``grad_gap.median``, the median leaf.
    Changes: the same of each leaf's change after the check steps, over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (the others move by rounding alone); ``change_gap`` and
    ``change_gap.median``.  The cell's limits file names those compared."""
    losses, grads, change = _gaps(got, ref)
    return {"loss_gap.first": max(losses[0]), "loss_gap": max(max(x) for x in losses),
            "grad_gap": max(grads.values()), "grad_gap.median": statistics.median(grads.values()),
            "change_gap": max(change.values()),
            "change_gap.median": statistics.median(change.values())}


def worst(got, ref):
    """Where the worst numbers are read: the step of the worst loss gap, and
    the worst leaves."""
    losses, grads, change = _gaps(got, ref)
    return {"loss_gap": max(range(len(losses)), key=lambda i: max(losses[i])),
            "grad_gap": max(grads, key=grads.get), "change_gap": max(change, key=change.get)}


def _window(setup, seconds, stop_flag):
    """Steps back to back until ``seconds`` have passed: (steps, window s,
    step intervals ms, the steps' loss terms)."""
    card = harness.CARD
    stamps, losses = [], []
    card.sync(setup.device)
    t0 = time.perf_counter()
    stamps.append(card.stamp())
    while True:
        losses.append(_terms(setup.step()))
        stamps.append(card.stamp())
        if stop_flag(time.perf_counter() - t0 >= seconds):
            break
    card.sync(setup.device)
    window_s = time.perf_counter() - t0
    intervals = [card.elapsed_ms(a, b) for a, b in zip(stamps, stamps[1:])]
    return len(losses), window_s, intervals, losses


def _terms(out):
    """A step's loss terms copied into one small tensor: on a mesh they are
    views of the step's all-reduce buffer, which holding them would keep."""
    return torch.stack([v.float() for v in out.values()])


def _nonfinite(losses):
    if not losses:
        return 0
    return int((~torch.isfinite(torch.stack(losses))).any(dim=1).sum())


def run_rank(cell, t0, device, mesh=None, rank=0, ranks=1):
    """One rank's run; rank 0's returns the result's pieces."""
    setup = Setup(cell, device, mesh, rank, ranks, keep_global=rank == 0)
    got = setup.check_steps()
    for _ in range(cell.mix["warmup_steps"]):
        setup.step()
    flag_group = None
    if mesh is not None and mesh.distributed:
        import torch.distributed as dist

        flag_group = dist.new_group(backend="gloo")

    def stop_flag(mine: bool) -> bool:
        if flag_group is None:
            return mine
        import torch.distributed as dist

        flag = torch.tensor([1 if mine else 0])
        dist.broadcast(flag, 0, group=flag_group)
        return bool(flag.item())

    card = harness.CARD
    card.sync(device)
    setup_s = time.time() - t0
    record = {"setup_s": setup_s, "ranks": ranks, "rows": cell.mix["batch"],
              "window_len": cell.mix["window"]}
    if cell.trace:
        from .. import trace

        n, warm = cell.mix["trace_steps"], cell.mix["trace_warmup"]
        done = []
        if cell.mix.get("trace_window"):  # the window's step intervals, read per layer
            _, _, record["window_step_ms"], done = _window(setup, cell.seconds, stop_flag)

        def one():
            done.append(_terms(setup.step()))

        card.sync(device)
        t_untraced = time.perf_counter()
        for _ in range(n):
            one()
        card.sync(device)
        record["untraced_window_s"] = time.perf_counter() - t_untraced
        for key, host in (("trace", False), ("host_trace", True)):
            if rank == 0 and card.traces:
                record[key] = trace.profile(one, n, host, warm)
            else:
                for _ in range(n + warm):
                    one()
        steps, losses = len(done), done
        record.update(steps=steps, trace_steps=n)
        record["kernel_calls"] = setup.fam.kernel_calls(setup.cfg, cell.mix, cell.mix["batch"])
    else:
        steps, window_s, intervals, losses = _window(setup, cell.seconds, stop_flag)
        record.update(steps=steps, window_s=window_s, step_ms=intervals)
    failed = _nonfinite(losses)
    peak = card.peak_bytes(device)
    cfg, weights = setup.cfg, setup.weights
    setup.program = setup.pool = losses = None  # the program's state, freed before the reference
    card.release()
    out = {"attempted": steps, "failed": failed, "peak": peak, "record": record}
    if rank == 0:
        if cell.trace:
            out["record"]["flops_per_step"] = step_flops(cell, cfg, weights)
        t_ref = time.perf_counter()
        ref = reference_readings(cell, setup)
        out["numbers"] = numbers(got, ref)
        out["reference_s"] = time.perf_counter() - t_ref
    return out


def step_flops(cell, cfg, weights):
    """FLOPs of one rank's step, counted over the reference on the meta
    device at the cell's shapes: the trunks' and BERT's forward, the trained
    stack's forward and backward."""
    from ..flops import count_flops, meta_like

    fam = harness.family(cell)
    one_row = fam.make_batch(torch.Generator(), cell.mix, cfg, "cpu", 1)  # the shapes
    batch = {k: torch.empty((cell.mix["batch"],) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta") for k, v in one_row.items()}
    ref = fam.Reference(meta_like(weights), fam.reference_sizes(cell.config, cfg), "float32",
                        None)
    return count_flops(fam.reference_step, ref, batch, cell.config)


def run(cell, t0):
    """The cell's run: one process, or one a card on several cards."""
    ranks = cell.mix.get("ranks", 1)
    if ranks == 1:
        return run_rank(cell, t0, harness.CARD.device)
    from robo_vln_tpu_torch.parallel.mesh import spawn

    out_dir = tempfile.mkdtemp(prefix="hcmbench-ranks-")
    try:
        spawn(_spawned_rank, ranks, harness.CARD.device, cell, t0, out_dir, harness.CARD,
              timeout_s=cell.mix.get("spawn_timeout_s", 900))
        outs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(ranks)]
    finally:
        import shutil

        shutil.rmtree(out_dir, ignore_errors=True)
    out = outs[0]
    out["peak"] = max(o["peak"] for o in outs)
    out["forbidden"] = sorted({m for o in outs for m in o["forbidden"]})
    return out


def _spawned_rank(rank, device, cell, t0, out_dir, card):
    """One rank's process: its run, and the forbidden modules loaded in it
    once its window has closed (the harness's guard reads them)."""
    from robo_vln_tpu_torch.parallel.mesh import DataMesh

    harness.CARD = card
    mesh = DataMesh(device)
    out = run_rank(cell, t0, device, mesh, rank, mesh.size)
    out["forbidden"] = harness.forbidden_loaded()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def checks(cell, out):
    """{number: {"value", "limit"}} of the numbers the cell's limits file
    names, and whether every one is within its limit (a number without a
    limit fails)."""
    table, ok = {}, bool(cell.limits)
    for key, limit in cell.limits.items():
        value = out["numbers"][key]
        table[key] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
    return table, ok
