"""The agents' serving entry points: the HCM agent's (counterpart of the
hierarchical eval tick, robo_vln_tpu/eval/evaluator.py:769-827, and of the
teacher-forced forward of __graft_entry__.entry() / bench.py:111-118) and
the flat family's (:class:`FlatAgent`, the flat eval tick,
evaluator.py:635-702).

:class:`HCMAgent` holds both policies on one device.  Each closed-loop tick
(:meth:`HCMAgent.act`) runs the frozen trunks once for both policies (when
their trunk weights are identical, the production path), the high level, the
argmax over its sub-goal logits, then the low level, at T=1, carrying both
LSTM states.  Frozen BERT runs once per episode: :meth:`embed_instruction`
caches the embedding of the last token ids it saw, compared on the host.  Everything runs under
``torch.no_grad()`` with the policies in eval mode, so there is no dropout;
a float32 agent runs with TF32 off for the call (utils/device.float32_exact).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import (
    build_hierarchical_policies,
    frozen_trunks_identical,
    make_shared_trunk_fn,
    sync_frozen_trunks,
)
from ..ops import cm_attention
from ..utils.device import float32_exact, resolve_device, resolve_dtype

Obs = Dict[str, torch.Tensor]


class HCMAgent:
    def __init__(self, high, low, share_frozen_trunks: bool = True):
        self.high, self.low = high.eval(), low.eval()
        self.trunk_fn = None
        if share_frozen_trunks and frozen_trunks_identical(high, low):
            self.trunk_fn = make_shared_trunk_fn(high)
        self._emb_ids: Optional[np.ndarray] = None
        self._emb: Optional[torch.Tensor] = None
        self.embeds = 0  # BERT's runs

    @property
    def device(self) -> torch.device:
        return next(self.high.parameters()).device

    def initial_state(self, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.high.initial_hidden(batch_size, self.device),
                self.low.initial_hidden(batch_size, self.device))

    @torch.no_grad()
    def embed_instruction(self, ids: torch.Tensor,
                          host_ids: Optional[np.ndarray] = None) -> torch.Tensor:
        """Frozen BERT over (B, L) token ids, cached while the ids stay the
        same (one episode per env-batch composition).  The ids are compared
        on the host: ``host_ids``, the same ids as the caller holds them
        there (the eval's observations), or else a copy of ``ids``."""
        key = ids.cpu().numpy() if host_ids is None else host_ids
        cached = self._emb_ids
        if cached is None or not np.array_equal(cached, key):
            self._emb_ids = np.array(key, copy=True)
            with float32_exact(self.high.compute_dtype):
                self._emb = self.high.embed_instruction(ids)
            self.embeds += 1
        return self._emb

    def _with_trunk_features(self, obs: Obs) -> Obs:
        return {**obs, **self.trunk_fn(obs)} if self.trunk_fn is not None else obs

    @torch.no_grad()
    def act(self, obs: Obs, state, prev: Optional[torch.Tensor], mask: torch.Tensor,
            host_ids: Optional[np.ndarray] = None):
        """One closed-loop tick.  obs: rgb (B, H, W, 3) uint8, depth
        (B, H, W, 1), instruction (B, L); state (hh, lh), each (2, B, H);
        mask (B,); ``host_ids`` as for :meth:`embed_instruction`.  Returns
        (actions (B, 2), stop (B, 1), (hh, lh))."""
        emb = self.embed_instruction(obs["instruction"], host_ids)
        return self.step({**obs, "instruction_embedding": emb}, state, prev, mask)

    @torch.no_grad()
    def step(self, obs: Obs, state, prev: Optional[torch.Tensor], mask: torch.Tensor):
        """The tick after BERT: :meth:`act` with ``obs["instruction_embedding"]``
        given.  Everything it runs stays on the device (no host copy, no
        host read), so the on-device eval captures it in a CUDA graph."""
        hh, lh = state
        with float32_exact(self.high.compute_dtype):
            obs = self._with_trunk_features(obs)
            logits, hh = self.high(obs, hh, prev, mask)
            pred = logits.argmax(dim=-1)
            actions, stop, lh = self.low(obs, lh, prev, mask, pred)
        return actions, stop, (hh, lh)

    @torch.no_grad()
    def forward_window(self, obs: Obs, masks: torch.Tensor, prev: Optional[torch.Tensor],
                       hh: torch.Tensor, lh: torch.Tensor):
        """The teacher-forced window: obs (B, T, ...) with instruction (B, L),
        masks (B, T).  Returns (actions (B, T, 2), stop (B, T, 1),
        logits (B, T, 4), hh, lh)."""
        with float32_exact(self.high.compute_dtype):
            obs = self._with_trunk_features(obs)
            logits, hh = self.high(obs, hh, prev, masks)
            pred = logits.argmax(dim=-1)
            actions, stop, lh = self.low(obs, lh, prev, masks, pred)
        return actions, stop, logits, hh, lh


def build_hcm_agent(model_config, device="cuda", compute_dtype="bfloat16",
                    seed: int = 0, weights=None,
                    share_frozen_trunks: bool = True,
                    pallas_attention: bool = False) -> HCMAgent:
    """The HCM agent on ``device`` (CUDA unless the caller asks for the CPU;
    an absent CUDA device raises).  ``weights`` = (high_vars, low_vars), the
    JAX package's variables as numpy trees, carried over by
    utils/weight_port.py; without it the weights are random from ``seed``
    and the low level's frozen trunks are synced to the high level's.
    ``pallas_attention`` is the config's TPU.PALLAS_ATTENTION: it sets the
    process-wide ops.cm_attention.set_float32_probabilities (bfloat16
    attention's p kept to about 16 bits, or rounded to bf16 once, the
    default), as the JAX trainers set theirs."""
    cm_attention.set_float32_probabilities(pallas_attention)
    dev = resolve_device(device)
    high, low = build_hierarchical_policies(
        model_config, compute_dtype=resolve_dtype(compute_dtype),
        generator=torch.Generator().manual_seed(seed),
    )
    if weights is None:
        sync_frozen_trunks(high, low)
    else:
        from ..utils.weight_port import load_hierarchical_weights

        load_hierarchical_weights(high, low, *weights)
    return HCMAgent(high.to(dev), low.to(dev), share_frozen_trunks)


class FlatAgent:
    """A flat policy (CMA or Seq2Seq) on one device, with the tick API of
    :class:`HCMAgent`: the eval's host driver, the DAgger mixer and the
    on-device rollout drive either.  The JAX package re-encodes the
    instruction every tick; the encoding (the GloVe or BERT instruction
    encoder's output, a function of the token ids alone in eval mode) is
    cached here on the host's view of the ids, as HCMAgent caches BERT's, so
    every tick computes what JAX computes.  The state is a 1-tuple holding
    the policy's packed hidden (layers, B, H)."""

    def __init__(self, policy):
        self.policy = policy.eval()
        self._emb_ids: Optional[np.ndarray] = None
        self._emb: Optional[torch.Tensor] = None
        self.embeds = 0  # the instruction encoder's runs

    @property
    def device(self) -> torch.device:
        return next(self.policy.parameters()).device

    def initial_state(self, batch_size: int) -> Tuple[torch.Tensor]:
        return (self.policy.initial_hidden(batch_size, self.device),)

    @torch.no_grad()
    def embed_instruction(self, ids: torch.Tensor,
                          host_ids: Optional[np.ndarray] = None) -> torch.Tensor:
        """The instruction encoder over (B, L) token ids, cached while the
        ids stay the same; ``host_ids`` as for HCMAgent.embed_instruction."""
        key = ids.cpu().numpy() if host_ids is None else host_ids
        cached = self._emb_ids
        if cached is None or not np.array_equal(cached, key):
            self._emb_ids = np.array(key, copy=True)
            with float32_exact(self.policy.compute_dtype):
                self._emb = self.policy.encode_instruction(ids)
            self.embeds += 1
        return self._emb

    @torch.no_grad()
    def act(self, obs: Obs, state, prev: Optional[torch.Tensor], mask: torch.Tensor,
            host_ids: Optional[np.ndarray] = None):
        """One closed-loop tick: obs rgb (B, H, W, 3), depth (B, H, W, 1),
        instruction (B, L); prev (B, 2); mask (B,).  Returns (actions (B, 2),
        stop (B, 1), state)."""
        emb = self.embed_instruction(obs["instruction"], host_ids)
        return self.step({**obs, "instruction_embedding": emb}, state, prev, mask)

    @torch.no_grad()
    def step(self, obs: Obs, state, prev: Optional[torch.Tensor], mask: torch.Tensor):
        """The tick with ``obs["instruction_embedding"]`` given: no host copy
        and no host read, so the on-device eval captures it."""
        with float32_exact(self.policy.compute_dtype):
            actions, stop, hidden, _ = self.policy(obs, state[0], prev, mask)
        return actions, stop, (hidden,)
