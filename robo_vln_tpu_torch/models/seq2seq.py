"""The Seq2Seq flat baseline (counterpart of robo_vln_tpu/models/seq2seq.py;
the reference's Seq2SeqNet, seq2seq.py:21-189).

The instruction's final state (the GloVe ``InstructionEncoder``, or the BERT
``LanguageEncoder`` when INSTRUCTION_ENCODER.is_bert) ∥ the depth embedding
∥ the rgb embedding (the ResNet encoders' vector modes, or ``SimpleCNN``
when ``cnn_type`` is SimpleDepthCNN / SimpleRGBCNN) [∥ the previous action's
embedding, SEQ2SEQ.use_prev_action] -> the masked state encoder ->
velocity (2) and stop (1), and with PROGRESS_MONITOR.use the progress
estimate tanh(progress_monitor(h)).  The reference builds
``progress_monitor`` and ``sub_goal_linear`` whether or not they are used,
so their keys are in the state_dict; nothing reads ``sub_goal_linear``.

Inputs keep the JAX layouts: observations (B, T, H, W, C) with the
instruction (B, L), or one tick (B, H, W, C); masks (B, T) or (B,); prev
actions (B, T, 2) or (B, 2); hidden (layers, B, H).  The instruction is
encoded once a call; ``observations["instruction_embedding"]``, the
encoder's output for the episode (:meth:`encode_instruction`), skips it.
The heads compute in float32, as the flax Dense layers without a dtype do.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .encoders.instruction import InstructionEncoder
from .encoders.language import LanguageEncoder
from .encoders.visual import DepthEncoder, RGBEncoder, SimpleCNN, visual_obs, visual_ref
from .hierarchical import _add_time_axis, _f32
from .rnn_state_encoder import RNNStateEncoder

PREV_ACTION_SIZE = 32


def embed_prev_action(table: nn.Embedding, prev_actions: Optional[torch.Tensor],
                      masks: torch.Tensor) -> torch.Tensor:
    """The previous action's embedding, indexed as the JAX package indexes
    it: int(((prev + 1) · mask)[..., 0]), the linear velocity truncated
    toward zero, a negative index counted from the end of the table and an
    index past it giving NaN (jnp.take's fill).  prev None reads as zero
    velocities.  (B, T) masks -> (B, T, 32)."""
    if prev_actions is None:
        prev_actions = masks.new_zeros(masks.shape + (2,))
    idx = ((prev_actions.float() + 1) * masks[..., None].float()).to(torch.int32)[..., 0].long()
    n = table.num_embeddings
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    rows = table(idx.clamp(0, n - 1))
    return torch.where(inside[..., None], rows, float("nan"))


def _frame_hw(model_config, rgb_hw):
    d = model_config.DEPTH_ENCODER.input_size
    return {"rgb": tuple(rgb_hw), "depth": (d, d)}


class Seq2SeqPolicy(nn.Module):
    def __init__(self, model_config, num_actions: int = 2, num_sub_tasks: int = 4,
                 compute_dtype=torch.float32, rgb_hw=(224, 224)):
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
        hw = _frame_hw(mc, rgb_hw)
        if mc.DEPTH_ENCODER.cnn_type == "SimpleDepthCNN":
            self.depth_encoder = SimpleCNN("depth", mc.DEPTH_ENCODER.output_size,
                                           hw["depth"], compute_dtype)
        else:
            self.depth_encoder = DepthEncoder(
                output_size=mc.DEPTH_ENCODER.output_size,
                input_size=mc.DEPTH_ENCODER.input_size,
                blocks=tuple(mc.DEPTH_ENCODER.blocks), compute_dtype=compute_dtype,
            )
        if mc.RGB_ENCODER.cnn_type == "SimpleRGBCNN":
            self.rgb_encoder = SimpleCNN("rgb", mc.RGB_ENCODER.output_size, hw["rgb"],
                                         compute_dtype)
        else:
            self.rgb_encoder = RGBEncoder(
                output_size=mc.RGB_ENCODER.output_size,
                blocks=tuple(mc.RGB_ENCODER.blocks), compute_dtype=compute_dtype,
            )
        H = mc.STATE_ENCODER.hidden_size
        rnn_in = (self.instruction_encoder.output_size + mc.DEPTH_ENCODER.output_size
                  + mc.RGB_ENCODER.output_size)
        if mc.SEQ2SEQ.use_prev_action:
            self.prev_action_embedding = nn.Embedding(num_actions + 1, PREV_ACTION_SIZE)
            rnn_in += PREV_ACTION_SIZE
        self.state_encoder = RNNStateEncoder(rnn_in, H, mc.STATE_ENCODER.rnn_type)
        self.progress_monitor = nn.Linear(H, 1)
        self.linear = nn.Linear(H, num_actions)
        self.stop_linear = nn.Linear(H, 1)
        self.sub_goal_linear = nn.Linear(H, num_sub_tasks)

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return self.state_encoder.initial_hidden(batch_size, device)

    def encode_instruction(self, instruction: torch.Tensor, generator=None) -> torch.Tensor:
        """The instruction's final state (B, H·dirs)."""
        if isinstance(self.instruction_encoder, LanguageEncoder):
            return self.instruction_encoder(instruction, generator)
        return self.instruction_encoder(instruction)

    def forward(self, observations: Dict[str, torch.Tensor], hidden: torch.Tensor,
                prev_actions: Optional[torch.Tensor], masks: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None):
        """Returns (actions, stop, hidden, aux): (B, T, 2), (B, T, 1) or, for
        one tick, (B, 2), (B, 1); aux["progress_hat"] (B, T), (B, 1) for a
        tick, with the progress monitor."""
        mc = self.model_config
        single = visual_ref(observations).dim() == 4
        if single:
            observations = _add_time_axis(observations)
            masks = masks[:, None]
            if prev_actions is not None:
                prev_actions = prev_actions[:, None]
        b, t = visual_ref(observations).shape[:2]
        n = b * t

        if "instruction_embedding" in observations:
            instruction = observations["instruction_embedding"]
        else:
            instruction = self.encode_instruction(observations["instruction"],
                                                  dropout_generator)
        depth = self.depth_encoder(visual_obs(observations, "depth", n))
        rgb = self.rgb_encoder(visual_obs(observations, "rgb", n))
        if mc.ablate_instruction:
            instruction = instruction * 0
        if mc.ablate_depth:
            depth = depth * 0
        if mc.ablate_rgb:
            rgb = rgb * 0

        parts = [instruction.float()[:, None].expand(b, t, -1),
                 depth.float().reshape(b, t, -1), rgb.float().reshape(b, t, -1)]
        if mc.SEQ2SEQ.use_prev_action:
            parts.append(embed_prev_action(self.prev_action_embedding, prev_actions, masks))
        x = torch.cat(parts, dim=-1)
        out, hidden = self.state_encoder(x.transpose(0, 1), hidden, masks.transpose(0, 1))
        out = out.transpose(0, 1)  # (B, T, H)

        aux = {}
        if mc.PROGRESS_MONITOR.use:
            aux["progress_hat"] = torch.tanh(_f32(out, self.progress_monitor))[..., 0]
        actions = _f32(out, self.linear)
        stop = _f32(out, self.stop_linear)
        if single:
            return actions[:, 0], stop[:, 0], hidden, aux
        return actions, stop, hidden, aux
