"""The imitation-learning train and val steps (counterpart of
robo_vln_tpu/training/steps.py): the flat family's (:func:`make_flat_train_step`,
:func:`make_flat_val_step`) and the hierarchical agent's.

Flat: one call is one TBPTT window of the CMA or Seq2Seq policy, the
velocity MSE (zero-target masked, or valid-masked with
TPU.VALID_MASK_VELOCITY_MSE), the stop BCE and, with the progress monitor,
alpha times its MSE where the target's linear velocity is not zero; one
backward and one Adam step over the trainable parameters; the same dropout
generator, non-finite guard, recompute and TF32 scoping as the
hierarchical step below.

Hierarchical: one call is one TBPTT window: the shared frozen trunks once for both
policies, the high level's sub-goal CE, the low level's velocity MSE and
stop BCE on the oracle sub-goals, then one backward over the summed loss
and an optimizer step of each policy (AdamW high, Adam low; see
training/optimizers.py).  The high-level loss does not depend on the low
level's parameters nor the low-level losses on the high level's (the low
level trains on ORACLE sub-goals), so the one backward gives both policies'
gradients, as the JAX step's one ``jax.grad`` does.

Dropout draws a fresh mask each step, reproducibly: the generator is seeded
from a fixed seed and the step counter (the high level's in the
hierarchical step; :func:`dropout_generator`),
as the JAX step folds the step into its key.  The bit stream is torch's, not
JAX's "rbg" stream, so the masks differ from the JAX package's; parity runs
set the dropout rate to 0.

A step clears the gradients when it starts, so after it each trainable
parameter's ``.grad`` holds the gradient it applied.  The progress monitors,
which the losses never reach, get none, so the optimizers leave them as
they are: the flax policies never create these parameters, so the JAX step
has nothing of theirs to update.

Non-finite guard: when the summed loss is not finite, neither optimizer
steps, so the parameters, the Adam moments and the optimizers' step counts
stay as they were (the JAX guard covers optax's count too), and no
gradient is kept; the train state's step counters still advance.  Deciding
this reads one scalar on the host, so the step synchronises with the device
once.

On a data-parallel mesh (``mesh``, parallel/mesh.DataMesh with a process
group) each rank takes its rows of the global window.  Every denominator of
the losses is then the count over the global batch: :func:`batch_counts`
gives the rank's counts, summed across the ranks in one all-reduce before
the forward (they depend on the batch alone), so each rank's loss is its
share of the global loss; the velocity MSE's mean over every element
becomes the rank's mean times its share of the elements.  One coalesced
all-reduce then sums the gradients, which gives the gradient of the global
loss, and the losses, from whose global sum every rank takes the same
non-finite decision and logs the same metrics.  Each rank draws its own
dropout masks (:func:`dropout_generator`'s ``rank``).  Without a process
group the step is the one-process step, bit for bit.

Float32 compute runs with TF32 off for the call (utils/device.float32_exact).
The step's forward, backward, all-reduce and optimizer update run in
profiler ranges (``flat_train_step.*``, ``hier_train_step.*``), which cost
nothing measurable when no profiler is on.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..ops import losses
from ..utils.device import float32_exact
from . import optimizers as opt_lib

DROPOUT_SEED = 17
_NOT_OBS = ("prev_actions", "corrected_actions", "oracle_stop", "not_done_masks",
            "valid_mask", "vln_oracle_action_sensor")


class TrainState(NamedTuple):
    optimizer: torch.optim.Optimizer  # over the policy's trainable parameters
    step: int


class HierTrainState(NamedTuple):
    high: TrainState
    low: TrainState


def dropout_generator(step: int, device, rank: int = 0) -> torch.Generator:
    """The dropout generator of one train step on one rank, on ``device``:
    the same masks for the same step and rank, others for another."""
    gen = torch.Generator(device=device)
    # the CPU generator reads the seed's low 32 bits only: the rank goes
    # above the step's bits there (steps below 2^24, ranks below 256)
    gen.manual_seed((DROPOUT_SEED << 32) + int(step) + (int(rank) << 24))
    return gen


def batch_counts(batch, inflection_coef=None, progress=False) -> Dict[str, torch.Tensor]:
    """The counts over ``batch`` that the losses divide by, as float32
    scalars: its episodes and those not all padding (the velocity MSE's
    rescaling), its velocity elements (the MSE's mean), its real steps
    (TPU.VALID_MASK_VELOCITY_MSE), its stop targets, and for the
    hierarchical step the labelled steps (the CE and the accuracy) or, with
    ``inflection_coef``, their summed inflection weights; with
    ``progress``, the progress monitor's steps."""
    valid = batch["valid_mask"]
    corrected = batch["corrected_actions"]
    counts = {"episodes": valid.shape[0], "real_episodes": (valid > 0).any(dim=1).sum(),
              "elements": corrected.numel(), "steps": (valid > 0).sum(),
              "stop": (batch["oracle_stop"] != -1.0).sum()}
    oracle = batch.get("vln_oracle_action_sensor")
    if oracle is not None:
        counts["labelled"] = (oracle != 0).sum()
        if inflection_coef is not None:
            weights = losses.inflection_weights(oracle, inflection_coef).reshape(-1)
            counts["subgoal_weight"] = torch.where(oracle.reshape(-1) == 0, 0.0, weights).sum()
    if progress:
        counts["progress"] = (corrected[..., 0] != 0).sum()
    return {k: torch.as_tensor(v, dtype=torch.float32, device=valid.device)
            for k, v in counts.items()}


def global_counts(mesh, batch, **kwargs) -> Optional[Dict[str, torch.Tensor]]:
    """The rank's :func:`batch_counts` summed across the ranks in one
    all-reduce, beside the rank's own element count (``local_elements``);
    None without a process group."""
    if mesh is None or not mesh.distributed:
        return None
    local = batch_counts(batch, **kwargs)
    summed = mesh.sum(torch.stack(list(local.values())))
    return {**dict(zip(local, summed.unbind())), "local_elements": local["elements"]}


def _pad_episode_correction(batch, counts=None) -> torch.Tensor:
    """Tail batches pad the BATCH axis with empty episodes.  The velocity
    MSE keeps the reference's mean over everything, so padded episodes
    would shrink it against the count-normalised stop and CE losses:
    rescale by B / real_B (exactly 1 on full batches), over the global
    batch where ``counts`` are given."""
    if counts is not None:  # B / real_B as Tensor.__rtruediv__ computes it below
        return torch.clamp(counts["real_episodes"], min=1).reciprocal() * counts["episodes"]
    valid = batch["valid_mask"]
    real_b = torch.clamp((valid > 0).any(dim=1).sum(), min=1)
    return valid.shape[0] / real_b.float()


def _velocity_mse(actions, batch, valid_velocity_mse: bool, counts=None) -> torch.Tensor:
    """The reference's zero-target masking by default; step-validity
    masking behind TPU.VALID_MASK_VELOCITY_MSE.  With global ``counts``,
    the rank's share of the global loss."""
    pred = actions.reshape(-1, 2)
    corrected = batch["corrected_actions"].reshape(-1, 2)
    if valid_velocity_mse:
        return losses.validmask_velocity_mse(pred, corrected, batch["valid_mask"].reshape(-1),
                                             None if counts is None else counts["steps"])
    mse = losses.masked_velocity_mse(pred, corrected)
    if counts is not None:  # the rank's mean, weighted by its share of the elements
        mse = mse * (counts["local_elements"] / counts["elements"])
    return mse * _pad_episode_correction(batch, counts)


_FLAT_NOT_OBS = ("prev_actions", "corrected_actions", "oracle_stop", "not_done_masks",
                 "valid_mask")


def _flat_losses(policy, batch, hidden, dropout_step=None, counts=None, rank=0, *,
                 progress_alpha, use_progress, valid_velocity_mse=False):
    """(velocity MSE, stop BCE, progress-monitor loss, new hidden) of one
    window; ``dropout_step``, ``counts`` and ``rank`` as for
    :func:`_hier_losses`."""
    obs = {k: v for k, v in batch.items() if k not in _FLAT_NOT_OBS}
    masks = batch["not_done_masks"]
    gen = None if dropout_step is None else dropout_generator(dropout_step, masks.device, rank)
    actions, stop, new_hidden, aux = policy(obs, hidden, batch["prev_actions"], masks, gen)
    corrected = batch["corrected_actions"].reshape(-1, 2)
    action_loss = _velocity_mse(actions, batch, valid_velocity_mse, counts)
    stop_loss = losses.masked_stop_bce(stop.reshape(-1, 1), batch["oracle_stop"].reshape(-1, 1),
                                       _count(counts, "stop"))
    aux_loss = action_loss.new_zeros(())
    if use_progress and "progress_hat" in aux:
        aux_mask = corrected[:, 0] != 0  # the reference's aux_mask
        aux_loss = progress_alpha * losses.progress_monitor_mse(
            aux["progress_hat"].reshape(-1), batch["progress"].reshape(-1), aux_mask,
            _count(counts, "progress"))
    return action_loss, stop_loss, aux_loss, new_hidden


def _count(counts, key):
    return None if counts is None else counts[key]


def _rank(mesh) -> int:
    return 0 if mesh is None else mesh.rank


def _apply(opts_lrs, params, grads, total) -> bool:
    """Set each parameter's ``.grad`` and step each optimizer at its lr,
    unless ``total`` is not finite (the step's one host sync); True when
    the optimizers stepped."""
    finite = torch.isfinite(total).item()
    if finite:
        for p, g in zip(params, grads):
            p.grad = g
        for opt, lr in opts_lrs:
            opt_lib.set_lr(opt, lr)
            opt.step()
    return finite


def _reduce(mesh, grads, scalars, prefix):
    """The gradients and loss terms summed over the ranks (as given
    without a process group)."""
    if mesh is None or not mesh.distributed:
        return list(grads), list(scalars)
    with record_function(f"{prefix}.all_reduce"):
        return mesh.reduce_step(grads, scalars)


def make_flat_train_step(policy, use_progress=False, progress_alpha=1.0, remat=False,
                         valid_velocity_mse=False, mesh=None):
    """Returns (state, hidden, batch, lr) -> (state, hidden, metrics), the
    flat policy's parameters and the optimizer of ``state`` updated in
    place, each trainable parameter's ``.grad`` left holding the step's
    gradient (None after a skipped step or where the losses never reach
    it); the returned state carries the advanced step counter.  Metrics:
    action_loss, stop_loss, aux_loss, total_loss, skipped_nonfinite.
    ``mesh``: the data-parallel mesh; ``batch`` is then the rank's rows
    and the metrics are the global batch's."""
    losses_fn = functools.partial(_flat_losses, policy, progress_alpha=progress_alpha,
                                  use_progress=use_progress,
                                  valid_velocity_mse=valid_velocity_mse)
    if remat:
        losses_fn = functools.partial(checkpoint, losses_fn, use_reentrant=False)

    def step_fn(state: TrainState, hidden, batch, lr):
        policy.train()
        opt = state.optimizer
        params = [p for group in opt.param_groups for p in group["params"]]
        opt.zero_grad(set_to_none=True)
        counts = global_counts(mesh, batch, progress=use_progress)
        with float32_exact(policy.compute_dtype):
            with record_function("flat_train_step.forward"):
                a, s, x, new_hidden = losses_fn(batch, hidden, state.step, counts, _rank(mesh))
                total = a + s + x
            with record_function("flat_train_step.backward"):
                grads = torch.autograd.grad(total, params, allow_unused=True)
        grads, (a, s, x) = _reduce(mesh, grads, (a.detach(), s.detach(), x.detach()),
                                   "flat_train_step")
        total = a + s + x
        with record_function("flat_train_step.optimizer"):
            finite = _apply([(opt, lr)], params, grads, total)
        metrics = {"action_loss": a.detach(), "stop_loss": s.detach(), "aux_loss": x.detach(),
                   "total_loss": total.detach(),
                   "skipped_nonfinite": total.new_tensor(0.0 if finite else 1.0)}
        return state._replace(step=state.step + 1), new_hidden, metrics

    return step_fn


def make_flat_val_step(policy, use_progress=False, progress_alpha=1.0,
                       valid_velocity_mse=False, mesh=None):
    """Returns (hidden, batch) -> (hidden, metrics), in eval mode (no
    dropout) and without a graph; ``mesh`` as for the train step."""

    @torch.no_grad()
    def step_fn(hidden, batch):
        policy.eval()
        counts = global_counts(mesh, batch, progress=use_progress)
        with float32_exact(policy.compute_dtype):
            a, s, x, new_hidden = _flat_losses(
                policy, batch, hidden, counts=counts, progress_alpha=progress_alpha,
                use_progress=use_progress, valid_velocity_mse=valid_velocity_mse)
        _, (a, s, x) = _reduce(mesh, (), (a, s, x), "flat_val_step")
        return new_hidden, {"action_loss": a, "stop_loss": s, "aux_loss": x,
                            "total_loss": a + s + x}

    return step_fn


def _hier_losses(high, low, batch, high_hidden, low_hidden, dropout_step=None, counts=None,
                 rank=0, trunk_fn=None, inflection_coef=None, valid_velocity_mse=False):
    """(high-level CE, low-level velocity MSE, low-level stop BCE, new high
    hidden, new low hidden, high-level accuracy) over one window.
    ``dropout_step``: the step whose dropout masks the high level draws (no
    dropout when None), on ``rank``; the generator is made here, so a
    recompute under ``checkpoint`` draws the same masks.  ``counts``: the
    global batch's (:func:`global_counts`), which make each term the
    rank's share of the global one; the batch's own when None."""
    obs = {k: v for k, v in batch.items() if k not in _NOT_OBS}
    if trunk_fn is not None and "rgb" in obs:
        obs = {**obs, **trunk_fn(obs)}  # the frozen trunks once, for both policies
    oracle = batch["vln_oracle_action_sensor"]
    masks = batch["not_done_masks"]
    b, t = masks.shape
    oracle_flat = oracle.reshape(-1).long()
    gen = None if dropout_step is None else dropout_generator(dropout_step, masks.device, rank)

    logits, new_high_hidden = high(obs, high_hidden, batch["prev_actions"], masks, gen)
    iw = (losses.inflection_weights(oracle.reshape(b, t), inflection_coef).reshape(-1)
          if inflection_coef is not None else None)
    hl_loss = losses.subgoal_cross_entropy(
        logits.reshape(-1, 4), oracle_flat, weights=iw,
        count=_count(counts, "labelled" if iw is None else "subgoal_weight"))

    # the low level takes the oracle sub-goals: sensor - 1, padding 0 -> 4
    disc = torch.where(oracle_flat == 0, 4, oracle_flat - 1).reshape(b, t)
    actions, stop, new_low_hidden = low(obs, low_hidden, batch["prev_actions"], masks, disc)
    ll_action = _velocity_mse(actions, batch, valid_velocity_mse, counts)
    ll_stop = losses.masked_stop_bce(stop.reshape(-1, 1), batch["oracle_stop"].reshape(-1, 1),
                                     _count(counts, "stop"))

    pred = logits.reshape(-1, 4).argmax(dim=1)
    valid = oracle_flat != 0
    correct = ((pred == oracle_flat - 1) & valid).sum()
    accuracy = correct / torch.clamp(valid.sum() if counts is None else counts["labelled"],
                                     min=1)
    return hl_loss, ll_action, ll_stop, new_high_hidden, new_low_hidden, accuracy


def _metrics(hl, ll_action, ll_stop, accuracy):
    hl, ll_action, ll_stop = hl.detach(), ll_action.detach(), ll_stop.detach()
    return {
        "high_level_loss": hl,
        "low_level_action_loss": ll_action,
        "low_level_stop_loss": ll_stop,
        "low_level_total_loss": ll_action + ll_stop,
        "high_level_accuracy": accuracy,
    }


def make_hier_train_step(high, low, trunk_fn=None, remat=False,
                         inflection_coef=None, valid_velocity_mse=False, mesh=None):
    """Returns (state, high_hidden, low_hidden, batch, lr_high, lr_low) ->
    (state, high_hidden, low_hidden, metrics).  The policies' parameters and
    the optimizers of ``state`` are updated in place, and each trainable
    parameter's ``.grad`` is left holding the step's gradient (None after a
    skipped step); the returned state carries the advanced step counters.

    remat (TPU.REMAT): the losses' forward is recomputed in the backward
    (``torch.utils.checkpoint``), so each kernel launches again there.
    trunk_fn: the shared frozen-trunk forward (models.make_shared_trunk_fn).
    inflection_coef: when set (TPU.APPLY_INFLECTION_WEIGHTS with
    DAGGER.USE_IW), the high-level CE is inflection-weighted.
    mesh: the data-parallel mesh; ``batch`` and the hidden states are then
    the rank's rows, and the metrics the global batch's."""
    losses_fn = functools.partial(_hier_losses, high, low, trunk_fn=trunk_fn,
                                  inflection_coef=inflection_coef,
                                  valid_velocity_mse=valid_velocity_mse)
    if remat:
        losses_fn = functools.partial(checkpoint, losses_fn, use_reentrant=False)

    def step_fn(state: HierTrainState, high_hidden, low_hidden, batch, lr_high, lr_low):
        high.train()
        low.train()
        opts = (state.high.optimizer, state.low.optimizer)
        params = [p for opt in opts for group in opt.param_groups for p in group["params"]]
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        counts = global_counts(mesh, batch, inflection_coef=inflection_coef)
        with float32_exact(high.compute_dtype):
            with record_function("hier_train_step.forward"):
                hl, ll_action, ll_stop, new_hh, new_lh, acc = losses_fn(
                    batch, high_hidden, low_hidden, state.high.step, counts, _rank(mesh))
                total = hl + ll_action + ll_stop
            with record_function("hier_train_step.backward"):
                grads = torch.autograd.grad(total, params, allow_unused=True)
        grads, (hl, ll_action, ll_stop, acc) = _reduce(
            mesh, grads, (hl.detach(), ll_action.detach(), ll_stop.detach(), acc),
            "hier_train_step")
        total = hl + ll_action + ll_stop
        with record_function("hier_train_step.optimizer"):
            _apply(zip(opts, (lr_high, lr_low)), params, grads, total)
        new_state = HierTrainState(state.high._replace(step=state.high.step + 1),
                                   state.low._replace(step=state.low.step + 1))
        return new_state, new_hh, new_lh, _metrics(hl, ll_action, ll_stop, acc)

    return step_fn


def make_hier_val_step(high, low, trunk_fn=None, valid_velocity_mse=False, mesh=None):
    """Returns (high_hidden, low_hidden, batch) -> (high_hidden, low_hidden,
    metrics), in eval mode (no dropout) and without a graph; ``mesh`` as for
    the train step."""

    @torch.no_grad()
    def step_fn(high_hidden, low_hidden, batch):
        high.eval()
        low.eval()
        counts = global_counts(mesh, batch)
        with float32_exact(high.compute_dtype):
            hl, ll_action, ll_stop, new_hh, new_lh, acc = _hier_losses(
                high, low, batch, high_hidden, low_hidden, counts=counts, trunk_fn=trunk_fn,
                valid_velocity_mse=valid_velocity_mse)
        _, (hl, ll_action, ll_stop, acc) = _reduce(mesh, (), (hl, ll_action, ll_stop, acc),
                                                   "hier_val_step")
        return new_hh, new_lh, _metrics(hl, ll_action, ll_stop, acc)

    return step_fn


def inflection_coef_from(config) -> Optional[float]:
    """MODEL.inflection_weight_coef when both TPU.APPLY_INFLECTION_WEIGHTS
    and DAGGER.USE_IW are set (the reference computes the weights and never
    applies them), else None."""
    if config.TPU.APPLY_INFLECTION_WEIGHTS and config.DAGGER.USE_IW:
        return config.MODEL.inflection_weight_coef
    return None
