"""The high level without the cross-modal transformer (counterpart of
robo_vln_tpu/models/hierarchical_seq2seq.py; the reference's
Seq2Seq_HighLevel, seq2seq_highlevel.py:21-186).

The instruction's final state (``LanguageEncoder`` over BERT when
INSTRUCTION_ENCODER.is_bert, else the GloVe ``InstructionEncoder``) ∥ the
depth embedding ∥ the rgb embedding (the ResNet encoders' vector modes) ->
the masked state encoder (the LSTM kernel) -> 4 sub-goal logits, no stop
head.  As in the JAX package no build function or yaml reaches it: the shipped
hierarchical trainer builds the CMA high level.  Inputs as
``HighLevelPolicy``'s: observations (B, T, H, W, C) with the instruction
(B, L), or one tick (B, H, W, C); masks (B, T) or (B,); hidden (2, B, H).
The logits compute in float32, as the flax Dense without a dtype does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .encoders.instruction import InstructionEncoder
from .encoders.language import LanguageEncoder
from .encoders.visual import DepthEncoder, RGBEncoder, visual_obs, visual_ref
from .hierarchical import _add_time_axis, _f32
from .rnn_state_encoder import RNNStateEncoder


class HighLevelSeq2SeqPolicy(nn.Module):
    def __init__(self, model_config, num_actions: int = 4, compute_dtype=torch.float32):
        super().__init__()
        mc = self.model_config = model_config
        self.compute_dtype = compute_dtype
        ic = mc.INSTRUCTION_ENCODER
        if ic.is_bert:
            self.instruction_encoder = LanguageEncoder(
                mc.BERT, hidden_size=ic.hidden_size, rnn_type=ic.rnn_type,
                final_state_only=True, bidirectional=ic.bidirectional,
                dropout_ratio=ic.dropout_ratio, compute_dtype=compute_dtype,
            )
        else:
            self.instruction_encoder = InstructionEncoder(
                vocab_size=ic.vocab_size, embedding_size=ic.embedding_size,
                hidden_size=ic.hidden_size, rnn_type=ic.rnn_type,
                final_state_only=True, bidirectional=ic.bidirectional,
            )
        self.depth_encoder = DepthEncoder(
            output_size=mc.DEPTH_ENCODER.output_size, input_size=mc.DEPTH_ENCODER.input_size,
            blocks=tuple(mc.DEPTH_ENCODER.blocks), compute_dtype=compute_dtype,
        )
        self.rgb_encoder = RGBEncoder(
            output_size=mc.RGB_ENCODER.output_size, blocks=tuple(mc.RGB_ENCODER.blocks),
            compute_dtype=compute_dtype,
        )
        H = mc.STATE_ENCODER.hidden_size
        rnn_in = (self.instruction_encoder.output_size + mc.DEPTH_ENCODER.output_size
                  + mc.RGB_ENCODER.output_size)
        self.state_encoder = RNNStateEncoder(rnn_in, H, mc.STATE_ENCODER.rnn_type)
        self.linear = nn.Linear(H, num_actions)

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return self.state_encoder.initial_hidden(batch_size, device)

    def forward(self, observations: Dict[str, torch.Tensor], hidden: torch.Tensor,
                prev_actions: Optional[torch.Tensor], masks: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None):
        """Returns (logits (B, T, 4) or, for one tick, (B, 4), hidden);
        ``prev_actions`` is unused, as in JAX."""
        mc = self.model_config
        single = visual_ref(observations).dim() == 4
        if single:
            observations = _add_time_axis(observations)
            masks = masks[:, None]
        b, t = visual_ref(observations).shape[:2]
        n = b * t
        if isinstance(self.instruction_encoder, LanguageEncoder):
            ins = self.instruction_encoder(observations["instruction"], dropout_generator)
        else:
            ins = self.instruction_encoder(observations["instruction"])
        depth = self.depth_encoder(visual_obs(observations, "depth", n))
        rgb = self.rgb_encoder(visual_obs(observations, "rgb", n))
        if mc.ablate_instruction:
            ins = ins * 0
        if mc.ablate_depth:
            depth = depth * 0
        if mc.ablate_rgb:
            rgb = rgb * 0
        x = torch.cat([ins.float()[:, None].expand(b, t, -1),
                       depth.float().reshape(b, t, -1), rgb.float().reshape(b, t, -1)], dim=-1)
        out, hidden = self.state_encoder(x.transpose(0, 1), hidden, masks.transpose(0, 1))
        logits = _f32(out.transpose(0, 1), self.linear)
        if single:
            return logits[:, 0], hidden
        return logits, hidden
