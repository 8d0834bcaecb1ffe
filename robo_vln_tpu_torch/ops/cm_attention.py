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
* :func:`single_query_attention` — the CMA policy's attention (plain
  PyTorch, no kernel, as in JAX): one query an example over S slots, the
  mask subtracted as 1e8 *before* the scale.
* :func:`set_float32_probabilities` — the process-wide setting that JAX's
  ``TPU.PALLAS_ATTENTION`` becomes in the port (the trainer and
  ``eval/agent.build_hcm_agent`` set it from the config, as the JAX trainers
  call ``set_use_pallas``).  It chooses what an unmasked bfloat16 call keeps
  of the probabilities p before p·v.  Off (the default, JAX's XLA
  attention, this module's :func:`mha_attention`): p rounded to bfloat16
  once.  On (JAX's Pallas kernel, whose p stays float32): p to about 16
  bits, p_hi + p_lo.  float32 calls and masked calls are the same either
  way.
* :func:`set_sow_attention` — ``PLOT_ATTENTION``'s switch, as in JAX: with it
  on, ``models/transformer.MultiHeadAttention`` still takes its output from
  :func:`attention_core` (the kernel on the card) and, beside it, for the
  plot only, computes the (B, h, Lq, Lk) softmax maps by
  :func:`attention_weights` and hands each to :func:`sow`, which appends it
  to the list of the innermost :func:`collect_sown` (none: dropped).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional

import torch

from . import fused_attention

_NEG_INF = -1e30

# process-global, as in JAX: set from the config by the trainer and
# build_hcm_agent; the sow switch by the eval (PLOT_ATTENTION)
_FLOAT32_PROBABILITIES = False
_SOW_ATTENTION = False
_SOWN: Optional[List[torch.Tensor]] = None


def set_float32_probabilities(enabled: bool) -> None:
    """Keep an unmasked bfloat16 call's probabilities to about 16 bits
    (JAX's TPU.PALLAS_ATTENTION on), or round them to bfloat16 once before
    p·v (off, the default)."""
    global _FLOAT32_PROBABILITIES
    _FLOAT32_PROBABILITIES = bool(enabled)


def float32_probabilities() -> bool:
    return _FLOAT32_PROBABILITIES


def set_sow_attention(enabled: bool) -> None:
    """PLOT_ATTENTION: make MultiHeadAttention sow its softmax weights,
    computed beside its output for the plot only."""
    global _SOW_ATTENTION
    _SOW_ATTENTION = bool(enabled)


def sow_attention() -> bool:
    return _SOW_ATTENTION


def sow(weights: torch.Tensor) -> None:
    if _SOWN is not None:
        _SOWN.append(weights)


@contextlib.contextmanager
def collect_sown() -> Iterator[List[torch.Tensor]]:
    """The weights sown inside the block, in call order."""
    global _SOWN
    outer, _SOWN = _SOWN, []
    try:
        yield _SOWN
    finally:
        _SOWN = outer


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
    dv = v.shape[-1] // num_heads
    vh = v.reshape(B, Lk, num_heads, dv).transpose(1, 2)
    att = attention_weights(q, k, num_heads, attention_mask)
    out = torch.matmul(att.to(vh.dtype), vh)
    out = out.transpose(1, 2).reshape(B, Lq, num_heads * dv)
    if return_weights:
        return out, att
    return out


def attention_weights(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                      attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`mha_attention`'s probabilities, (B, h, Lq, Lk) float32: the
    softmax of q·kᵀ / √d_k, masked entries zero."""
    B, Lq, _ = q.shape
    Lk = k.shape[1]
    dk = q.shape[-1] // num_heads
    qh = q.reshape(B, Lq, num_heads, dk).transpose(1, 2)
    kh = k.reshape(B, Lk, num_heads, dk).transpose(1, 2)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(dk)
    if attention_mask is not None:
        logits = logits.masked_fill(attention_mask, _NEG_INF)
    att = torch.softmax(logits, dim=-1)
    if attention_mask is not None:
        att = att.masked_fill(attention_mask, 0.0)
    return att


def single_query_attention(
    q: torch.Tensor,  # (N, C)
    k: torch.Tensor,  # (N, C, S)
    v: torch.Tensor,  # (N, Cv, S)
    scale: float,
    mask: Optional[torch.Tensor] = None,  # (N, S) bool, True = masked
) -> torch.Tensor:
    """The reference CMANet's ``_attn`` (cma.py:201-209), channel-major:
    logits q·k in float32, minus 1e8 where masked, *then* times ``scale``,
    softmax over the S slots.  Returns (N, Cv)."""
    logits = torch.einsum("nc,ncs->ns", q.float(), k.float())
    if mask is not None:
        logits = logits - mask.float() * 1e8
    att = torch.softmax(logits * scale, dim=1)
    return torch.einsum("ns,ncs->nc", att.to(v.dtype), v)
