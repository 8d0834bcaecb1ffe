"""The hierarchical cross-modal (HCM) agent's train step, plain: Irshad et al.,
"Hierarchical Cross-Modal Agent for Robotics Vision-and-Language Navigation"
(ICRA 2021), as GT-RIPL/robo-vln's hierarchical_cma.yaml builds it.

High level: BERT over the instruction; spatial rgb (16 tokens of 2048 + 64)
and depth (64 tokens of 32 + 64) features; a 1×1 projection of each to 256;
one cross-modal block (instruction queries × visual tokens) applied to both,
each output averaged over the instruction; ∥ rgb and depth vectors -> LSTM ->
4 sub-goal logits.  Low level: depth and rgb vectors ∥ a sub-goal embedding
-> LSTM -> velocity (2) and stop (1).  The loss is the sub-goal cross
entropy, the masked velocity MSE and the masked stop BCE, summed; AdamW
steps the high level and Adam the low one.

Weights are a dict under the published modules' names, prefixed ``high.``
and ``low.``; the low level's frozen trunks are the high level's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import (Adam, Arith, dropout, exact_float32, layer_norm, lstm, multi_head_attention,
                  sinusoid_table, stop_bce, subgoal_ce, velocity_mse)
from .trunks import bert, gn_resnet50, tv_resnet50

LN_EPS = 1e-6
FROZEN = ("high.embedding_layer.", "high.rgb_encoder.cnn.", "high.depth_encoder.visual_encoder.",
          "low.rgb_encoder.cnn.", "low.depth_encoder.visual_encoder.")
TRUNK_BLOCK = 100  # frames a block through the trunks


def trainable(name: str) -> bool:
    return not name.startswith(FROZEN) and not name.endswith(("running_mean", "running_var"))


def scrambled(table):
    """A (S, C) spatial table read as the published ``.view(1, -1, h, w)``
    reads it: channel k of token s is the flat table's element k·S + s."""
    return table.reshape(table.shape[1], table.shape[0]).t()


@torch.no_grad()
def trunk_features(A: Arith, w, rgb, depth, block=TRUNK_BLOCK):
    """(rgb features (N, 7, 7, 2048), depth features (N, 8, 8, 32)) of frames
    (N, ...), in blocks of ``block`` frames."""
    out = [], []
    for i in range(0, rgb.shape[0], block):
        out[0].append(tv_resnet50(A, w, "high.rgb_encoder.cnn.", rgb[i:i + block]))
        out[1].append(gn_resnet50(A, w, "high.depth_encoder.visual_encoder.", depth[i:i + block]))
    return torch.cat(out[0]), torch.cat(out[1])


def cross_modal(A: Arith, w, p, ins, vis, heads, rate, gen):
    """The cross-modal block: instruction (N, L, C) queries over visual tokens
    (N, S, C') -> (N, L, d); one LayerNorm serves both inputs, the sinusoid
    table is added to the queries; attention and the feed-forward are post-LN
    residuals; dropout after each input stage, after the output projection
    and after both feed-forward layers, in that order."""
    ln = (w[p + "layer_norm.weight"], w[p + "layer_norm.bias"], LN_EPS)
    v = layer_norm(dropout(F.relu(A.linear(vis, w[p + "vis_fc.weight"], w[p + "vis_fc.bias"])),
                           rate, gen), *ln)
    q = layer_norm(dropout(F.relu(A.linear(ins, w[p + "ins_fc.weight"], w[p + "ins_fc.bias"])),
                           rate, gen), *ln)
    q = q + sinusoid_table(q.shape[1], q.shape[2], q.device)
    layer = 0
    while f"{p}layers.{layer}.enc_att.attention.fc_q.weight" in w:
        b = f"{p}layers.{layer}."

        def lin(name, x):
            return A.linear(x, w[b + name + ".weight"], w[b + name + ".bias"])

        att = multi_head_attention(A, lin("enc_att.attention.fc_q", q),
                                   lin("enc_att.attention.fc_k", v),
                                   lin("enc_att.attention.fc_v", v), heads)
        x = layer_norm(q + dropout(lin("enc_att.attention.fc_o", att), rate, gen),
                       w[b + "enc_att.layer_norm.weight"], w[b + "enc_att.layer_norm.bias"],
                       LN_EPS)
        y = dropout(F.relu(lin("pwff.fc1", x)), rate, gen)
        y = dropout(lin("pwff.fc2", y), rate, gen)
        v = layer_norm(x + y, w[b + "pwff.layer_norm.weight"], w[b + "pwff.layer_norm.bias"],
                       LN_EPS)
        layer += 1
    return v


def _lin(A, w, p, x):
    return A.linear(x, w[p + ".weight"], w[p + ".bias"])


def _lstm(A, w, p, x, hidden, masks):
    """x (B, T, D), hidden (2, B, H), masks (B, T) -> (out (B, T, H), hidden)."""
    outs, h, c = lstm(A, x.transpose(0, 1), hidden[0], hidden[1], masks.t(),
                      w[p + ".weight_ih_l0"], w[p + ".weight_hh_l0"], w[p + ".bias_ih_l0"],
                      w[p + ".bias_hh_l0"])
    return outs.transpose(0, 1), torch.stack([h, c])


def high_level(A: Arith, w, rgb_f, depth_f, emb, masks, hidden, sizes, gen):
    """Sub-goal logits (B, T, 4) and the new hidden state; rgb_f, depth_f
    (B·T, h, w, C), emb (B, L, 768)."""
    b, t = masks.shape
    n = b * t
    pooled = F.adaptive_avg_pool2d(rgb_f.permute(0, 3, 1, 2), (4, 4))
    rgb_tok = pooled.permute(0, 2, 3, 1).reshape(n, 16, -1)
    rgb_tok = torch.cat([rgb_tok, scrambled(w["high.rgb_encoder.spatial_embeddings.weight"])
                         .expand(n, -1, -1)], -1)
    depth_tok = depth_f.reshape(n, -1, depth_f.shape[-1])
    depth_tok = torch.cat([depth_tok, scrambled(w["high.depth_encoder.spatial_embeddings.weight"])
                           .expand(n, -1, -1)], -1)
    ins = emb[:, None].expand(b, t, *emb.shape[1:]).reshape(n, *emb.shape[1:])
    rgb_kv = A.linear(rgb_tok, w["high.rgb_kv.weight"][:, :, 0], w["high.rgb_kv.bias"])
    depth_kv = A.linear(depth_tok, w["high.depth_kv.weight"][:, :, 0], w["high.depth_kv.bias"])
    cm = "high.image_cm_encoder."
    heads, rate = sizes["attn_heads"], sizes["attn_dropout"]
    rgb_att = cross_modal(A, w, cm, ins, rgb_kv, heads, rate, gen).mean(1)
    depth_att = cross_modal(A, w, cm, ins, depth_kv, heads, rate, gen).mean(1)
    rgb_in = F.relu(_lin(A, w, "high.rgb_linear.2", rgb_tok.mean(1)))
    depth_in = F.relu(_lin(A, w, "high.depth_linear.1", depth_tok.transpose(1, 2).reshape(n, -1)))
    x = torch.cat([rgb_in, depth_in, rgb_att, depth_att], 1).reshape(b, t, -1)
    out, hidden = _lstm(A, w, "high.state_encoder.rnn", x, hidden, masks)
    return _lin(A, w, "high.linear", out), hidden


def low_level(A: Arith, w, rgb_f, depth_f, sub_goal, masks, hidden):
    """Velocities (B, T, 2), stop logits (B, T, 1) and the new hidden state;
    sub_goal (B, T) in 0-3, 4 for none (embedded as zeros)."""
    b, t = masks.shape
    n = b * t
    depth_in = F.relu(_lin(A, w, "low.depth_encoder.visual_fc.1",
                           depth_f.permute(0, 3, 1, 2).reshape(n, -1)))
    rgb_in = F.relu(_lin(A, w, "low.rgb_encoder.fc", rgb_f.mean(dim=(1, 2))))
    ids = sub_goal.reshape(n).long()
    sub = w["low.sub_task_embedding.weight"][ids] * (ids != 4).float()[:, None]
    x = torch.cat([depth_in, rgb_in, sub], 1).reshape(b, t, -1)
    out, hidden = _lstm(A, w, "low.state_encoder.rnn", x, hidden, masks)
    return _lin(A, w, "low.linear", out), _lin(A, w, "low.stop_linear", out), hidden


def losses(logits, actions, stop, batch):
    oracle = batch["vln_oracle_action_sensor"].reshape(-1)
    return {"high_level_loss": subgoal_ce(logits.reshape(-1, 4), oracle),
            "low_level_action_loss": velocity_mse(actions.reshape(-1, 2),
                                                  batch["corrected_actions"].reshape(-1, 2)),
            "low_level_stop_loss": stop_bce(stop.reshape(-1, 1),
                                            batch["oracle_stop"].reshape(-1, 1))}


class Reference:
    """The HCM train step over a copy of ``weights``.  ``sizes``: the
    configuration's attn_heads, attn_dropout, bert_heads, weight_decay_high
    and weight_decay_low.  ``dropout_seed(step, rank)`` gives the seed of
    the dropout masks of a step's rows of one data rank (None: no dropout)."""

    def __init__(self, weights, sizes, precision="float32", dropout_seed=None):
        self.A = Arith(precision)
        self.sizes = sizes
        self.frozen = {k: v for k, v in weights.items() if not trainable(k)}
        self.params = {k: v.detach().clone().float() for k, v in weights.items() if trainable(k)}
        self.opt = {"high": Adam(sizes["weight_decay_high"], decoupled=True),
                    "low": Adam(sizes["weight_decay_low"])}
        self.dropout_seed = dropout_seed
        self.hidden = None
        self.steps = 0

    def _gen(self, rank, device):
        if self.dropout_seed is None or device.type == "meta":
            return None
        return torch.Generator(device=device).manual_seed(self.dropout_seed(self.steps, rank))

    def step(self, batch, lr_high, lr_low, ranks=1):
        """One window; the global batch's rows are the data ranks' in turn,
        each rank's drawing its own dropout masks.  Returns ({loss: float32
        scalar}, {leaf: gradient})."""
        A, sizes = self.A, self.sizes
        masks = batch["not_done_masks"].float()
        b, t = masks.shape
        dev = masks.device
        if self.hidden is None:
            H = self.params["high.state_encoder.rnn.weight_hh_l0"].shape[1]
            self.hidden = [torch.zeros(2, b, H, device=dev) for _ in range(2)]
        with exact_float32(), A.scope():
            rgb_f, depth_f = trunk_features(A, self.frozen, batch["rgb"].flatten(0, 1),
                                            batch["depth"].flatten(0, 1))
            with torch.no_grad():
                emb = bert(A, self.frozen, "high.embedding_layer.", batch["instruction"],
                           sizes["bert_heads"])
            params = {k: v.detach().requires_grad_() for k, v in self.params.items()}
            w = {**self.frozen, **params}
            rows = b // ranks
            logits, hh = [], []
            for r in range(ranks):
                sl = slice(r * rows, (r + 1) * rows)
                fr = slice(r * rows * t, (r + 1) * rows * t)
                lg, h = high_level(A, w, rgb_f[fr], depth_f[fr], emb[sl], masks[sl],
                                   self.hidden[0][:, sl], sizes, self._gen(r, dev))
                logits.append(lg)
                hh.append(h)
            logits = torch.cat(logits)
            oracle = batch["vln_oracle_action_sensor"]
            sub_goal = torch.where(oracle == 0, 4, oracle.long() - 1)
            actions, stop, lh = low_level(A, w, rgb_f, depth_f, sub_goal, masks, self.hidden[1])
            terms = losses(logits, actions, stop, batch)
            total = sum(terms.values())
            names = list(params)
            grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
        grads = {k: g for k, g in zip(names, grads) if g is not None}
        for level, lr in (("high", lr_high), ("low", lr_low)):
            self.opt[level].step(self.params, {k: g for k, g in grads.items()
                                               if k.startswith(level + ".")}, lr)
        self.hidden = [torch.cat(hh, 1).detach(), lh.detach()]
        self.steps += 1
        return {k: v.detach() for k, v in terms.items()}, grads
