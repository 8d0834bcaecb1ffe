"""Imitation-learning losses with the reference's masking (counterpart of
robo_vln_tpu/ops/losses.py).

Every quirk is kept:

* velocity MSE: the prediction is zeroed wherever the *target* is exactly 0,
  and the mean runs over ALL elements, padded ones included;
* stop BCE: only where the target is not -1 (the padding value), as a mean
  over those elements, in the stable log-sigmoid form;
* sub-goal CE: logits rows zeroed where the oracle sub-goal is 0, labels are
  (sub-goal - 1), and rows with oracle 0 are ignored.

Each count-normalised loss takes its denominator as ``count`` where it is
given: on a data-parallel mesh the count over the global batch
(training/steps.batch_counts summed across the ranks), so that a rank's
loss is its share of the global loss.  Without it, the count is the
tensor's own, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_velocity_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE over (.., 2) velocities, the prediction zeroed where the target
    is 0; the mean is over the whole tensor."""
    pred = torch.where(target != 0.0, pred, 0.0)
    return ((pred - target) ** 2).mean()


def validmask_velocity_mse(pred: torch.Tensor,  # (N, 2)
                           target: torch.Tensor,  # (N, 2)
                           valid: torch.Tensor,  # (N,) 1 on real steps, 0 on padding
                           count: Optional[torch.Tensor] = None,  # real steps
                           ) -> torch.Tensor:
    """MSE over (v, omega) masked by step validity, the mean over real steps
    (TPU.VALID_MASK_VELOCITY_MSE, a deviation from the reference)."""
    keep = valid[:, None] > 0
    per = torch.where(keep, (pred - target) ** 2, 0.0)
    if count is None:
        count = keep.sum()
    denom = torch.clamp(count * pred.shape[-1], min=1)
    return per.sum() / denom


def masked_stop_bce(logits: torch.Tensor, target: torch.Tensor,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE with logits over the elements whose target is not -1."""
    valid = target != -1.0
    t = torch.where(valid, target, 0.0)
    per = torch.clamp(logits, min=0.0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    per = torch.where(valid, per, 0.0)
    return per.sum() / torch.clamp(valid.sum() if count is None else count, min=1)


def subgoal_cross_entropy(logits: torch.Tensor,  # (N, C)
                          oracle_actions: torch.Tensor,  # (N,) sensor values; 0 = ignore
                          weights: Optional[torch.Tensor] = None,  # (N,)
                          count: Optional[torch.Tensor] = None,
                          ) -> torch.Tensor:
    """Cross entropy over labels (oracle - 1), the rows where the oracle is 0
    zeroed and ignored.  With ``weights`` the reduction is sum(w·nll) over
    sum(w) on the rows not ignored (floored at 1e-6); without, the mean over
    those rows.  ``count``: that sum of weights, or that number of rows."""
    ignore = oracle_actions == 0
    labels = oracle_actions.long() - 1
    logits = torch.where(ignore[:, None], 0.0, logits)
    logz = torch.log_softmax(logits, dim=-1)
    safe = labels.clamp(0, logits.shape[-1] - 1)
    nll = -logz.gather(-1, safe[:, None])[:, 0]
    nll = torch.where(ignore, 0.0, nll)
    if weights is not None:
        nll = nll * weights
        if count is None:
            count = torch.where(ignore, 0.0, weights).sum()
        denom = torch.clamp(count, min=1e-6)
    else:
        denom = torch.clamp((~ignore).sum() if count is None else count, min=1)
    return nll.sum() / denom


def inflection_weights(oracle_actions: torch.Tensor,  # (B, T) sensor values
                       coef: float) -> torch.Tensor:
    """``coef`` where the action differs from the previous step's (the
    window's first step counts as a change), else 1.0."""
    prev = torch.cat([torch.full_like(oracle_actions[:, :1], -1),
                      oracle_actions[:, :-1]], dim=1)
    ones = torch.ones_like(oracle_actions, dtype=torch.float32)
    return torch.where(oracle_actions != prev, float(coef), ones)


def progress_monitor_mse(progress_hat: torch.Tensor,  # (N,)
                         progress: torch.Tensor,  # (N,)
                         mask: torch.Tensor,  # (N,) bool, the valid steps
                         count: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """Elementwise MSE reduced as a mean over the masked steps."""
    per = torch.where(mask, (progress_hat - progress) ** 2, 0.0)
    return per.sum() / torch.clamp(mask.sum() if count is None else count, min=1)
