"""The hierarchical cross-modal (HCM) agent's two policies (counterpart of
robo_vln_tpu/models/hierarchical.py).

High level (:class:`HighLevelPolicy`): BERT instruction embedding (frozen
unless ``MODEL.BERT.trainable``);
spatial rgb (16 tokens × 2112) and depth (64 tokens × 96) features; rgb_kv /
depth_kv 1×1 convs feed ONE VisualLingAttn, applied to the rgb tokens and then
to the depth tokens with the same weights, each output mean-pooled over the
instruction tokens; ∥ rgb_linear ∥ depth_linear -> LSTM(512) -> 4 sub-goal
logits.  In training mode, given a dropout generator, VisualLingAttn drops
at ``VISUAL_LING_ATTN.dropout``.

Low level (:class:`LowLevelPolicy`): depth ∥ rgb vector embeddings ∥ a
sub-task embedding (5 × 32; id 4 is padding and embeds to zero) ->
LSTM(512) -> velocity (2) and stop (1); no dropout.

Inputs keep the JAX layouts: observations (B, T, H, W, C) or, for one tick,
(B, H, W, C); masks (B, T) or (B,); hidden (2, B, H).  The heads outside the
encoders compute in float32, as the flax Dense layers without a dtype do.
Parameter names follow the reference's torch modules, so the reference's
state_dicts and the JAX package's checkpoint converter apply unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .encoders.bert import BertEncoder
from .encoders.visual import DepthEncoder, RGBEncoder, visual_obs, visual_ref
from .rnn_state_encoder import RNNStateEncoder
from ..utils.profiling import module_range
from .transformer import VisualLingAttn, linear

_EPISODE_KEYS = ("instruction", "instruction_embedding")


def _add_time_axis(observations):
    return {k: (v if k in _EPISODE_KEYS else v[:, None])
            for k, v in observations.items()}


def _conv1x1(x: torch.Tensor, m: nn.Conv1d) -> torch.Tensor:
    """A 1×1 Conv1d over the channels of (N, S, C) tokens, in float32."""
    return F.linear(x.float(), m.weight[:, :, 0], m.bias)


def _f32(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    return linear(x, m, torch.float32)


class HighLevelPolicy(nn.Module):
    def __init__(self, model_config, num_actions: int = 4, compute_dtype=torch.float32):
        super().__init__()
        mc = self.model_config = model_config
        self.compute_dtype = compute_dtype
        bc, va = mc.BERT, mc.VISUAL_LING_ATTN
        self.embedding_layer = BertEncoder(
            vocab_size=bc.vocab_size, hidden_size=bc.hidden_size,
            num_layers=bc.num_layers, num_heads=bc.num_heads,
            intermediate_size=bc.intermediate_size,
            max_position_embeddings=bc.max_position_embeddings,
            type_vocab_size=bc.type_vocab_size, compute_dtype=compute_dtype,
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
        rgb_c = 2048 + 64
        depth_c = self.depth_encoder.visual_encoder.compression_channels + 64
        depth_s = self.depth_encoder.spatial_embeddings.num_embeddings
        self.rgb_kv = nn.Conv1d(rgb_c, va.vis_in_features, 1)
        self.depth_kv = nn.Conv1d(depth_c, va.vis_in_features, 1)
        self.image_cm_encoder = VisualLingAttn(
            d_model=va.d_model, h=va.h, d_ff=va.d_ff, n_layers=va.N,
            vis_in_features=va.vis_in_features,
            ins_in_features=va.ins_in_features, compute_dtype=compute_dtype,
            dropout=va.dropout,
        )
        # the reference's Sequentials: the Linear is index 2 and 1
        self.rgb_linear = nn.Sequential(
            nn.AdaptiveAvgPool1d(1), nn.Flatten(),
            nn.Linear(rgb_c, mc.RGB_ENCODER.output_size), nn.ReLU(True),
        )
        self.depth_linear = nn.Sequential(
            nn.Flatten(), nn.Linear(depth_c * depth_s, mc.DEPTH_ENCODER.output_size),
            nn.ReLU(True),
        )
        H = mc.STATE_ENCODER.hidden_size
        self.state_encoder = RNNStateEncoder(
            2 * va.d_model + mc.RGB_ENCODER.output_size + mc.DEPTH_ENCODER.output_size,
            H, mc.STATE_ENCODER.rnn_type,
        )
        self.progress_monitor = nn.Linear(H, 1)  # in the reference, unused
        self.linear = nn.Linear(H, num_actions)

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return self.state_encoder.initial_hidden(batch_size, device)

    def embed_instruction(self, instruction: torch.Tensor) -> torch.Tensor:
        """BERT over the token ids -> (B, L, hidden), float32.  The
        instruction is constant over an episode, so the serving loop runs
        this once per episode and passes it back as
        ``observations["instruction_embedding"]``.  Frozen BERT (the
        reference's) runs under ``no_grad``; ``MODEL.BERT.trainable`` keeps
        its graph, so the instruction pathway trains end to end."""
        if self.model_config.BERT.trainable:
            return self.embedding_layer(instruction)
        with torch.no_grad():
            return self.embedding_layer(instruction)

    @module_range("HighLevelPolicy")
    def forward(self, observations: Dict[str, torch.Tensor], hidden: torch.Tensor,
                prev_actions: Optional[torch.Tensor], masks: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None):
        mc = self.model_config
        single = visual_ref(observations).dim() == 4
        if single:
            observations = _add_time_axis(observations)
            masks = masks[:, None]
        b, t = visual_ref(observations).shape[:2]
        n = b * t

        depth_tokens = self.depth_encoder(visual_obs(observations, "depth", n))
        rgb_tokens = self.rgb_encoder(visual_obs(observations, "rgb", n))
        if mc.ablate_depth:
            depth_tokens = depth_tokens * 0
        if mc.ablate_rgb:
            rgb_tokens = rgb_tokens * 0

        if "instruction_embedding" in observations:
            embedded_b = observations["instruction_embedding"].to(self.compute_dtype)
        else:
            embedded_b = self.embed_instruction(observations["instruction"])
        embedded = embedded_b[:, None].expand(b, t, *embedded_b.shape[1:])
        embedded = embedded.reshape(n, *embedded_b.shape[1:])

        rgb_spatial = _conv1x1(rgb_tokens, self.rgb_kv)  # (N, 16, 256)
        depth_spatial = _conv1x1(depth_tokens, self.depth_kv)  # (N, 64, 256)
        gen = dropout_generator
        ins_rgb_att = self.image_cm_encoder(embedded, rgb_spatial, generator=gen).mean(1)
        ins_depth_att = self.image_cm_encoder(embedded, depth_spatial, generator=gen).mean(1)

        rgb_in = F.relu(_f32(rgb_tokens.mean(1), self.rgb_linear[2]))
        depth_flat = depth_tokens.transpose(1, 2).reshape(n, -1)  # channel-major
        depth_in = F.relu(_f32(depth_flat, self.depth_linear[1]))

        x = torch.cat([rgb_in, depth_in, ins_rgb_att, ins_depth_att], dim=1)
        out, hidden = self.state_encoder(
            x.reshape(b, t, -1).transpose(0, 1), hidden, masks.transpose(0, 1)
        )
        logits = _f32(out.transpose(0, 1), self.linear)  # (B, T, A)
        if single:
            return logits[:, 0], hidden
        return logits, hidden


class LowLevelPolicy(nn.Module):
    def __init__(self, model_config, num_actions: int = 2, num_sub_tasks: int = 4,
                 compute_dtype=torch.float32):
        super().__init__()
        mc = self.model_config = model_config
        self.num_sub_tasks = num_sub_tasks
        self.depth_encoder = DepthEncoder(
            output_size=mc.DEPTH_ENCODER.output_size,
            input_size=mc.DEPTH_ENCODER.input_size,
            blocks=tuple(mc.DEPTH_ENCODER.blocks), compute_dtype=compute_dtype,
        )
        self.rgb_encoder = RGBEncoder(
            output_size=mc.RGB_ENCODER.output_size,
            blocks=tuple(mc.RGB_ENCODER.blocks), compute_dtype=compute_dtype,
        )
        self.sub_task_embedding = nn.Embedding(
            num_sub_tasks + 1, 32, padding_idx=num_sub_tasks
        )
        H = mc.STATE_ENCODER.hidden_size
        self.state_encoder = RNNStateEncoder(
            mc.DEPTH_ENCODER.output_size + mc.RGB_ENCODER.output_size + 32,
            H, mc.STATE_ENCODER.rnn_type,
        )
        self.progress_monitor = nn.Linear(H, 1)  # in the reference, unused
        self.linear = nn.Linear(H, num_actions)
        self.stop_linear = nn.Linear(H, 1)

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return self.state_encoder.initial_hidden(batch_size, device)

    @module_range("LowLevelPolicy")
    def forward(self, observations: Dict[str, torch.Tensor], hidden: torch.Tensor,
                prev_actions: Optional[torch.Tensor], masks: torch.Tensor,
                discrete_actions: torch.Tensor):
        """discrete_actions (B, T) or (B,): sub-task ids, 4 = padding."""
        mc = self.model_config
        single = visual_ref(observations).dim() == 4
        if single:
            observations = _add_time_axis(observations)
            masks = masks[:, None]
            discrete_actions = discrete_actions[:, None]
        b, t = visual_ref(observations).shape[:2]
        n = b * t

        depth_embedding = self.depth_encoder(visual_obs(observations, "depth", n))
        rgb_embedding = self.rgb_encoder(visual_obs(observations, "rgb", n))
        if mc.ablate_depth:
            depth_embedding = depth_embedding * 0
        if mc.ablate_rgb:
            rgb_embedding = rgb_embedding * 0

        ids = discrete_actions.reshape(n).long()
        sub = self.sub_task_embedding(ids)
        sub = sub.masked_fill((ids == self.num_sub_tasks)[:, None], 0.0)

        x = torch.cat([depth_embedding.float(), rgb_embedding.float(), sub], dim=1)
        out, hidden = self.state_encoder(
            x.reshape(b, t, -1).transpose(0, 1), hidden, masks.transpose(0, 1)
        )
        out = out.transpose(0, 1)
        actions = _f32(out, self.linear)
        stop = _f32(out, self.stop_linear)
        if single:
            return actions[:, 0], stop[:, 0], hidden
        return actions, stop, hidden
