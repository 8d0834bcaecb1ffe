"""Multi-head attention core with the reference's masking convention
(counterpart of robo_vln_tpu/ops/cm_attention.py:55-106).

* :func:`mha_attention` — plain PyTorch: logits / √d_k in float32, masked
  logits filled with -1e30 before the softmax and zeroed after it (a fully
  masked row gives zeros, not NaNs), then the value contraction.  BERT's
  self-attention calls it directly.
* :func:`attention_core` — what the transformer blocks call.  It dispatches by
  meaning, as in JAX: a masked call, or a call that asks for the weights,
  takes :func:`mha_attention`; every other call takes
  ``ops/fused_attention.fused_cross_modal_attention``, which launches the
  CUDA kernel on a CUDA tensor and runs the plain version on a CPU tensor.
  Unlike JAX (``TPU.PALLAS_ATTENTION``) there is no switch that turns the
  kernel off on the card.
* :func:`set_float32_probabilities` — the process-wide setting that JAX's
  ``TPU.PALLAS_ATTENTION`` becomes in the port (the trainer and
  ``eval/agent.build_hcm_agent`` set it from the config, as the JAX trainers
  call ``set_use_pallas``).  It chooses what an unmasked bfloat16 call keeps
  of the probabilities p before p·v.  Off (the default, JAX's XLA
  attention, this module's :func:`mha_attention`): p rounded to bfloat16
  once.  On (JAX's Pallas kernel, whose p stays float32): p to about 16
  bits, p_hi + p_lo.  float32 calls and masked calls are the same either
  way.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import fused_attention

_NEG_INF = -1e30

# process-global, as in JAX: set from the config by the trainer and
# build_hcm_agent
_FLOAT32_PROBABILITIES = False


def set_float32_probabilities(enabled: bool) -> None:
    """Keep an unmasked bfloat16 call's probabilities to about 16 bits
    (JAX's TPU.PALLAS_ATTENTION on), or round them to bfloat16 once before
    p·v (off, the default)."""
    global _FLOAT32_PROBABILITIES
    _FLOAT32_PROBABILITIES = bool(enabled)


def float32_probabilities() -> bool:
    return _FLOAT32_PROBABILITIES


def attention_core(q, k, v, num_heads: int,
                   attention_mask: Optional[torch.Tensor] = None,
                   return_weights: bool = False):
    if attention_mask is None and not return_weights:
        return fused_attention.fused_cross_modal_attention(q, k, v, num_heads)
    return mha_attention(q, k, v, num_heads, attention_mask,
                         return_weights=return_weights)


def mha_attention(
    q: torch.Tensor,  # (B, Lq, h*dk)
    k: torch.Tensor,  # (B, Lk, h*dk)
    v: torch.Tensor,  # (B, Lk, h*dv)
    num_heads: int,
    attention_mask: Optional[torch.Tensor] = None,  # bool, True = masked;
    # broadcastable to (B, h, Lq, Lk)
    return_weights: bool = False,
):
    """Returns (B, Lq, h*dv), or (out, weights (B, h, Lq, Lk)) when
    return_weights.  Softmax in float32; the output keeps v's dtype."""
    B, Lq, _ = q.shape
    Lk = k.shape[1]
    dk = q.shape[-1] // num_heads
    dv = v.shape[-1] // num_heads
    qh = q.reshape(B, Lq, num_heads, dk).transpose(1, 2)
    kh = k.reshape(B, Lk, num_heads, dk).transpose(1, 2)
    vh = v.reshape(B, Lk, num_heads, dv).transpose(1, 2)

    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(dk)
    if attention_mask is not None:
        logits = logits.masked_fill(attention_mask, _NEG_INF)
    att = torch.softmax(logits, dim=-1)
    if attention_mask is not None:
        att = att.masked_fill(attention_mask, 0.0)
    out = torch.matmul(att.to(vh.dtype), vh)
    out = out.transpose(1, 2).reshape(B, Lq, num_heads * dv)
    if return_weights:
        return out, att
    return out
