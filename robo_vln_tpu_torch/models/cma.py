"""The Cross-Modal Attention (CMA) flat baseline (counterpart of
robo_vln_tpu/models/cma.py; the reference's CMANet, cma.py:20-333).

  1st state encoder over [rgb_linear ∥ depth_linear (∥ prev action)]
  state -> text attention (``state_q`` against ``text_k``, masked at pads)
  text -> rgb and text -> depth attention (1×1 ``rgb_kv`` / ``depth_kv``)
  2nd state encoder over [state ∥ text ∥ rgb-att ∥ depth-att (∥ prev action)]
  -> velocity (2) and stop (1) (and the progress estimate with
  PROGRESS_MONITOR.use)

As in JAX the attentions are not recurrent: the sequence forward runs the
encoders over all T·B frames, the first state encoder, the attentions
batched over the frames, then the second state encoder.  The instruction is
encoded once a call (the reference re-encodes a copy a frame) by the GloVe
``InstructionEncoder`` in its channel-major full-sequence mode, whose exact
zeros at pads give the text mask; ``observations["instruction_embedding"]``
(that (B, C, L) output, :meth:`encode_instruction`) skips it.  The hidden
state packs both encoders' (4, B, H) for LSTMs: [h1, c1, h2, c2].  Both
state encoders are LSTMs in every shipped config and run the LSTM kernel
(models/rnn_state_encoder.py), two calls a forward.

The attentions are single-query softmaxes in plain PyTorch
(``ops/cm_attention.single_query_attention``), einsums in JAX: no kernel.
The heads and 1×1 convs compute in float32, the trunks in the compute
dtype; the depth tokens are flattened channel-major for ``depth_linear``.

With ``MODEL.CMA.rcm_state_encoder`` the first state encoder is the RCM
encoder (models/rcm.py): a GRU whose input at each step is attention from
its last output over the raw rgb and depth tokens (and the previous-action
input: the embedding with CMA.use_prev_action, else the raw velocities);
``rgb_linear`` and ``depth_linear`` are not built, and the hidden packs
[GRU h, last output, h2, c2], still (4, B, H).  Only the second state
encoder then runs the LSTM kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cm_attention import single_query_attention
from .encoders.instruction import InstructionEncoder
from .encoders.visual import DepthEncoder, RGBEncoder, visual_obs, visual_ref
from .hierarchical import _add_time_axis, _conv1x1, _f32
from .rcm import RCMStateEncoder
from .rnn_state_encoder import RNNStateEncoder
from .seq2seq import PREV_ACTION_SIZE, embed_prev_action


def attn_tokens(q, k, v, scale: float, mask=None):
    """The reference CMANet's ``_attn`` on token-major k (N, S, C) and v
    (N, S, Cv): the JAX package's ``_attn_tokens``."""
    return single_query_attention(q, k.transpose(1, 2), v.transpose(1, 2), scale, mask)


class CMAPolicy(nn.Module):
    def __init__(self, model_config, num_actions: int = 2, compute_dtype=torch.float32):
        super().__init__()
        mc = self.model_config = model_config
        self.rcm = bool(mc.CMA.rcm_state_encoder)
        self.compute_dtype = compute_dtype
        ic = mc.INSTRUCTION_ENCODER
        self.instruction_encoder = InstructionEncoder(
            vocab_size=ic.vocab_size, embedding_size=ic.embedding_size,
            hidden_size=ic.hidden_size, rnn_type=ic.rnn_type,
            final_state_only=False,  # forced by CMANet (cma.py:31-34)
            bidirectional=ic.bidirectional,
        )
        self.depth_encoder = DepthEncoder(
            output_size=mc.DEPTH_ENCODER.output_size, spatial_output=True,
            input_size=mc.DEPTH_ENCODER.input_size,
            blocks=tuple(mc.DEPTH_ENCODER.blocks), compute_dtype=compute_dtype,
        )
        self.rgb_encoder = RGBEncoder(
            output_size=mc.RGB_ENCODER.output_size, spatial_output=True,
            blocks=tuple(mc.RGB_ENCODER.blocks), compute_dtype=compute_dtype,
        )
        H, rgb_out, depth_out = (mc.STATE_ENCODER.hidden_size, mc.RGB_ENCODER.output_size,
                                 mc.DEPTH_ENCODER.output_size)
        self.hidden_size = H
        rgb_c = 2048 + 64
        depth_c = self.depth_encoder.visual_encoder.compression_channels + 64
        depth_s = self.depth_encoder.spatial_embeddings.num_embeddings
        ins_c = self.instruction_encoder.output_size
        pa = PREV_ACTION_SIZE if mc.CMA.use_prev_action else 0
        rnn_type = mc.STATE_ENCODER.rnn_type
        if self.rcm:
            # the prev-action input: the embedding, else the raw velocities
            self.state_encoder = RCMStateEncoder(rgb_c, depth_c, pa or num_actions, H)
        else:
            # the reference's Sequentials: the Linear is index 2, 1 and 0
            self.rgb_linear = nn.Sequential(
                nn.AdaptiveAvgPool1d(1), nn.Flatten(), nn.Linear(rgb_c, rgb_out),
                nn.ReLU(True))
            self.depth_linear = nn.Sequential(
                nn.Flatten(), nn.Linear(depth_c * depth_s, depth_out), nn.ReLU(True))
            self.state_encoder = RNNStateEncoder(rgb_out + depth_out + pa, H, rnn_type)
        self.second_state_encoder = RNNStateEncoder(H, H, rnn_type)
        if pa:
            self.prev_action_embedding = nn.Embedding(num_actions + 1, PREV_ACTION_SIZE)
        self.rgb_kv = nn.Conv1d(rgb_c, H // 2 + rgb_out, 1)
        self.depth_kv = nn.Conv1d(depth_c, H // 2 + depth_out, 1)
        self.state_q = nn.Linear(H, H // 2)
        self.text_k = nn.Conv1d(ins_c, H // 2, 1)
        self.text_q = nn.Linear(ins_c, H // 2)
        self.second_state_compress = nn.Sequential(
            nn.Linear(H + ins_c + rgb_out + depth_out + pa, H), nn.ReLU(True))
        self.progress_monitor = nn.Linear(H, 1)
        self.linear = nn.Linear(H, num_actions)
        self.stop_linear = nn.Linear(H, 1)

    @property
    def _first_layers(self) -> int:
        return self.state_encoder.num_recurrent_layers

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.cat([self.state_encoder.initial_hidden(batch_size, device),
                          self.second_state_encoder.initial_hidden(batch_size, device)])

    def encode_instruction(self, instruction: torch.Tensor, generator=None) -> torch.Tensor:
        """The instruction's padded output sequence, channel-major (B, C, L)."""
        return self.instruction_encoder(instruction)

    def forward(self, observations: Dict[str, torch.Tensor], hidden: torch.Tensor,
                prev_actions: Optional[torch.Tensor], masks: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None):
        """Returns (actions, stop, hidden, aux) as Seq2SeqPolicy.forward; CMA
        has no dropout, so ``dropout_generator`` is unused."""
        mc = self.model_config
        single = visual_ref(observations).dim() == 4
        if single:
            observations = _add_time_axis(observations)
            masks = masks[:, None]
            if prev_actions is not None:
                prev_actions = prev_actions[:, None]
        b, t = visual_ref(observations).shape[:2]
        n = b * t

        depth_tokens = self.depth_encoder(visual_obs(observations, "depth", n))  # (N, S, C)
        rgb_tokens = self.rgb_encoder(visual_obs(observations, "rgb", n))  # (N, 16, 2112)
        if "instruction_embedding" in observations:
            ins_cl = observations["instruction_embedding"]
        else:
            ins_cl = self.encode_instruction(observations["instruction"])
        text_mask_b = (ins_cl == 0.0).all(dim=1)  # (B, L)
        ins_lc = ins_cl.transpose(1, 2)  # (B, L, C)
        if mc.ablate_instruction:
            ins_lc = ins_lc * 0
        if mc.ablate_depth:
            depth_tokens = depth_tokens * 0
        if mc.ablate_rgb:
            rgb_tokens = rgb_tokens * 0

        masks_tm = masks.transpose(0, 1)
        extra = []
        if mc.CMA.use_prev_action:
            extra = [embed_prev_action(self.prev_action_embedding, prev_actions,
                                       masks).reshape(n, -1)]
        k = self._first_layers
        if self.rcm:
            if extra:
                pa_in = extra[0]
            elif prev_actions is not None:
                pa_in = prev_actions.reshape(n, -1)
            else:  # None reads as zero velocities, as on the other paths
                pa_in = rgb_tokens.new_zeros(n, 2, dtype=torch.float32)

            def time_major(x):
                return x.reshape(b, t, *x.shape[1:]).transpose(0, 1)

            state_seq, hid1 = self.state_encoder(
                time_major(rgb_tokens), time_major(depth_tokens), time_major(pa_in),
                hidden[:k], masks_tm)
        else:
            rgb_in = F.relu(_f32(rgb_tokens.mean(1), self.rgb_linear[2]))
            depth_flat = depth_tokens.transpose(1, 2).reshape(n, -1)  # channel-major
            depth_in = F.relu(_f32(depth_flat, self.depth_linear[1]))
            state_in = torch.cat([rgb_in, depth_in, *extra], dim=1).reshape(b, t, -1)
            state_seq, hid1 = self.state_encoder(state_in.transpose(0, 1), hidden[:k],
                                                 masks_tm)
        state = state_seq.transpose(0, 1).reshape(n, -1)

        half = self.hidden_size // 2
        scale = 1.0 / math.sqrt(half)
        L, C = ins_lc.shape[1:]
        ins_tb = ins_lc[:, None].expand(b, t, L, C).reshape(n, L, C)
        text_mask = text_mask_b[:, None].expand(b, t, L).reshape(n, L)
        text_embedding = attn_tokens(_f32(state, self.state_q), _conv1x1(ins_tb, self.text_k),
                                     ins_tb, scale, text_mask)  # (N, C)
        rgb_kv = _conv1x1(rgb_tokens, self.rgb_kv)
        depth_kv = _conv1x1(depth_tokens, self.depth_kv)
        text_q = _f32(text_embedding, self.text_q)
        rgb_att = attn_tokens(text_q, rgb_kv[..., :half], rgb_kv[..., half:], scale)
        depth_att = attn_tokens(text_q, depth_kv[..., :half], depth_kv[..., half:], scale)

        x = torch.cat([state, text_embedding, rgb_att, depth_att, *extra], dim=1)
        x = F.relu(_f32(x, self.second_state_compress[0])).reshape(b, t, -1)
        out_seq, hid2 = self.second_state_encoder(x.transpose(0, 1), hidden[k:], masks_tm)
        out = out_seq.transpose(0, 1)  # (B, T, H)
        hidden = torch.cat([hid1, hid2], dim=0)

        aux = {}
        if mc.PROGRESS_MONITOR.use:
            aux["progress_hat"] = torch.tanh(_f32(out, self.progress_monitor))[..., 0]
        actions = _f32(out, self.linear)
        stop = _f32(out, self.stop_linear)
        if single:
            return actions[:, 0], stop[:, 0], hidden, aux
        return actions, stop, hidden, aux
