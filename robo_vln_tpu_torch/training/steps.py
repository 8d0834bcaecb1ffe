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

Float32 compute runs with TF32 off for the call (utils/device.float32_exact).
The step's forward, backward and optimizer update run in profiler ranges
(``flat_train_step.*``, ``hier_train_step.*``), which cost nothing measurable when no profiler is
on.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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


def dropout_generator(step: int, device) -> torch.Generator:
    """The dropout generator of one train step, on ``device``: the same
    masks for the same step, others for another."""
    gen = torch.Generator(device=device)
    gen.manual_seed((DROPOUT_SEED << 32) + int(step))
    return gen


def _pad_episode_correction(batch) -> torch.Tensor:
    """Tail batches pad the BATCH axis with empty episodes.  The velocity
    MSE keeps the reference's mean over everything, so padded episodes
    would shrink it against the count-normalised stop and CE losses:
    rescale by B / real_B (exactly 1 on full batches)."""
    valid = batch["valid_mask"]
    real_b = torch.clamp((valid > 0).any(dim=1).sum(), min=1)
    return valid.shape[0] / real_b.float()


def _velocity_mse(actions, batch, valid_velocity_mse: bool) -> torch.Tensor:
    """The reference's zero-target masking by default; step-validity
    masking behind TPU.VALID_MASK_VELOCITY_MSE."""
    pred = actions.reshape(-1, 2)
    corrected = batch["corrected_actions"].reshape(-1, 2)
    if valid_velocity_mse:
        return losses.validmask_velocity_mse(pred, corrected, batch["valid_mask"].reshape(-1))
    return losses.masked_velocity_mse(pred, corrected) * _pad_episode_correction(batch)


_FLAT_NOT_OBS = ("prev_actions", "corrected_actions", "oracle_stop", "not_done_masks",
                 "valid_mask")


def _flat_losses(policy, batch, hidden, dropout_step=None, *, progress_alpha,
                 use_progress, valid_velocity_mse=False):
    """(velocity MSE, stop BCE, progress-monitor loss, new hidden) of one
    window; ``dropout_step`` as for :func:`_hier_losses`."""
    obs = {k: v for k, v in batch.items() if k not in _FLAT_NOT_OBS}
    masks = batch["not_done_masks"]
    gen = None if dropout_step is None else dropout_generator(dropout_step, masks.device)
    actions, stop, new_hidden, aux = policy(obs, hidden, batch["prev_actions"], masks, gen)
    corrected = batch["corrected_actions"].reshape(-1, 2)
    action_loss = _velocity_mse(actions, batch, valid_velocity_mse)
    stop_loss = losses.masked_stop_bce(stop.reshape(-1, 1), batch["oracle_stop"].reshape(-1, 1))
    aux_loss = action_loss.new_zeros(())
    if use_progress and "progress_hat" in aux:
        aux_mask = corrected[:, 0] != 0  # the reference's aux_mask
        aux_loss = progress_alpha * losses.progress_monitor_mse(
            aux["progress_hat"].reshape(-1), batch["progress"].reshape(-1), aux_mask)
    return action_loss, stop_loss, aux_loss, new_hidden


def make_flat_train_step(policy, use_progress=False, progress_alpha=1.0, remat=False,
                         valid_velocity_mse=False):
    """Returns (state, hidden, batch, lr) -> (state, hidden, metrics), the
    flat policy's parameters and the optimizer of ``state`` updated in
    place, each trainable parameter's ``.grad`` left holding the step's
    gradient (None after a skipped step or where the losses never reach
    it); the returned state carries the advanced step counter.  Metrics:
    action_loss, stop_loss, aux_loss, total_loss, skipped_nonfinite."""
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
        with float32_exact(policy.compute_dtype):
            with record_function("flat_train_step.forward"):
                a, s, x, new_hidden = losses_fn(batch, hidden, state.step)
                total = a + s + x
            with record_function("flat_train_step.backward"):
                grads = torch.autograd.grad(total, params, allow_unused=True)
        with record_function("flat_train_step.optimizer"):
            finite = torch.isfinite(total).item()  # the step's one host sync
            if finite:
                for p, g in zip(params, grads):
                    p.grad = g
                opt_lib.set_lr(opt, lr)
                opt.step()
        metrics = {"action_loss": a.detach(), "stop_loss": s.detach(), "aux_loss": x.detach(),
                   "total_loss": total.detach(),
                   "skipped_nonfinite": total.new_tensor(0.0 if finite else 1.0)}
        return state._replace(step=state.step + 1), new_hidden, metrics

    return step_fn


def make_flat_val_step(policy, use_progress=False, progress_alpha=1.0,
                       valid_velocity_mse=False):
    """Returns (hidden, batch) -> (hidden, metrics), in eval mode (no
    dropout) and without a graph."""

    @torch.no_grad()
    def step_fn(hidden, batch):
        policy.eval()
        with float32_exact(policy.compute_dtype):
            a, s, x, new_hidden = _flat_losses(
                policy, batch, hidden, progress_alpha=progress_alpha,
                use_progress=use_progress, valid_velocity_mse=valid_velocity_mse)
        return new_hidden, {"action_loss": a, "stop_loss": s, "aux_loss": x,
                            "total_loss": a + s + x}

    return step_fn


def _hier_losses(high, low, batch, high_hidden, low_hidden, dropout_step=None,
                 trunk_fn=None, inflection_coef=None, valid_velocity_mse=False):
    """(high-level CE, low-level velocity MSE, low-level stop BCE, new high
    hidden, new low hidden, high-level accuracy) over one window.
    ``dropout_step``: the step whose dropout masks the high level draws (no
    dropout when None); the generator is made here, so a recompute under
    ``checkpoint`` draws the same masks."""
    obs = {k: v for k, v in batch.items() if k not in _NOT_OBS}
    if trunk_fn is not None and "rgb" in obs:
        obs = {**obs, **trunk_fn(obs)}  # the frozen trunks once, for both policies
    oracle = batch["vln_oracle_action_sensor"]
    masks = batch["not_done_masks"]
    b, t = masks.shape
    oracle_flat = oracle.reshape(-1).long()
    gen = None if dropout_step is None else dropout_generator(dropout_step, masks.device)

    logits, new_high_hidden = high(obs, high_hidden, batch["prev_actions"], masks, gen)
    iw = (losses.inflection_weights(oracle.reshape(b, t), inflection_coef).reshape(-1)
          if inflection_coef is not None else None)
    hl_loss = losses.subgoal_cross_entropy(logits.reshape(-1, 4), oracle_flat, weights=iw)

    # the low level takes the oracle sub-goals: sensor - 1, padding 0 -> 4
    disc = torch.where(oracle_flat == 0, 4, oracle_flat - 1).reshape(b, t)
    actions, stop, new_low_hidden = low(obs, low_hidden, batch["prev_actions"], masks, disc)
    ll_action = _velocity_mse(actions, batch, valid_velocity_mse)
    ll_stop = losses.masked_stop_bce(stop.reshape(-1, 1), batch["oracle_stop"].reshape(-1, 1))

    pred = logits.reshape(-1, 4).argmax(dim=1)
    valid = oracle_flat != 0
    correct = ((pred == oracle_flat - 1) & valid).sum()
    accuracy = correct / torch.clamp(valid.sum(), min=1)
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
                         inflection_coef=None, valid_velocity_mse=False):
    """Returns (state, high_hidden, low_hidden, batch, lr_high, lr_low) ->
    (state, high_hidden, low_hidden, metrics).  The policies' parameters and
    the optimizers of ``state`` are updated in place, and each trainable
    parameter's ``.grad`` is left holding the step's gradient (None after a
    skipped step); the returned state carries the advanced step counters.

    remat (TPU.REMAT): the losses' forward is recomputed in the backward
    (``torch.utils.checkpoint``), so each kernel launches again there.
    trunk_fn: the shared frozen-trunk forward (models.make_shared_trunk_fn).
    inflection_coef: when set (TPU.APPLY_INFLECTION_WEIGHTS with
    DAGGER.USE_IW), the high-level CE is inflection-weighted."""
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
        with float32_exact(high.compute_dtype):
            with record_function("hier_train_step.forward"):
                hl, ll_action, ll_stop, new_hh, new_lh, acc = losses_fn(
                    batch, high_hidden, low_hidden, state.high.step)
                total = hl + ll_action + ll_stop
            with record_function("hier_train_step.backward"):
                grads = torch.autograd.grad(total, params, allow_unused=True)
        with record_function("hier_train_step.optimizer"):
            if torch.isfinite(total).item():  # the step's one host sync
                for p, g in zip(params, grads):
                    p.grad = g
                for opt, lr in zip(opts, (lr_high, lr_low)):
                    opt_lib.set_lr(opt, lr)
                    opt.step()
        new_state = HierTrainState(state.high._replace(step=state.high.step + 1),
                                   state.low._replace(step=state.low.step + 1))
        return new_state, new_hh, new_lh, _metrics(hl, ll_action, ll_stop, acc)

    return step_fn


def make_hier_val_step(high, low, trunk_fn=None, valid_velocity_mse=False):
    """Returns (high_hidden, low_hidden, batch) -> (high_hidden, low_hidden,
    metrics), in eval mode (no dropout) and without a graph."""

    @torch.no_grad()
    def step_fn(high_hidden, low_hidden, batch):
        high.eval()
        low.eval()
        with float32_exact(high.compute_dtype):
            hl, ll_action, ll_stop, new_hh, new_lh, acc = _hier_losses(
                high, low, batch, high_hidden, low_hidden, trunk_fn=trunk_fn,
                valid_velocity_mse=valid_velocity_mse)
        return new_hh, new_lh, _metrics(hl, ll_action, ll_stop, acc)

    return step_fn


def inflection_coef_from(config) -> Optional[float]:
    """MODEL.inflection_weight_coef when both TPU.APPLY_INFLECTION_WEIGHTS
    and DAGGER.USE_IW are set (the reference computes the weights and never
    applies them), else None."""
    if config.TPU.APPLY_INFLECTION_WEIGHTS and config.DAGGER.USE_IW:
        return config.MODEL.inflection_weight_coef
    return None
