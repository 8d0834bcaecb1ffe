"""The cross-modal attention (CMA) baseline's train step, plain: Krantz et al.,
"Beyond the Nav-Graph" (ECCV 2020), as GT-RIPL/robo-vln's cma_robo.yaml
builds it (CMANet).

GloVe embeddings (trained here, no file) -> a bidirectional LSTM over the
valid tokens -> the instruction's states (B, L, 512), zero at the pads.
Spatial rgb and depth features as in the HCM's high level; rgb and depth
vectors -> a first LSTM (the state); the state's single query over the
instruction (pads masked), the result's single query over the rgb and over
the depth tokens; [state ∥ text ∥ rgb ∥ depth] -> Linear -> ReLU -> a second
LSTM -> velocity (2) and stop (1).  The loss is the masked velocity MSE and
the masked stop BCE; Adam steps every trained leaf.  Weights are a dict under
CMANet's names with no prefix.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .hcm import TRUNK_BLOCK, _lin, _lstm, scrambled
from .ops import Adam, Arith, exact_float32, stop_bce, velocity_mse
from .trunks import gn_resnet50, tv_resnet50

FROZEN = ("rgb_encoder.cnn.", "depth_encoder.visual_encoder.")


def trainable(name: str) -> bool:
    return not name.startswith(FROZEN) and not name.endswith(("running_mean", "running_var"))


def bi_lstm(A: Arith, w, p, x, lengths):
    """The packed bidirectional LSTM: x (B, L, D), lengths (B,) -> (B, L,
    2H), each direction over the first ``lengths`` tokens only, zero past
    them."""
    b, L, _ = x.shape
    H = w[p + "weight_hh_l0"].shape[1]
    out = []
    for suffix, steps in (("", range(L)), ("_reverse", range(L - 1, -1, -1))):
        w_ih, w_hh = w[f"{p}weight_ih_l0{suffix}"], w[f"{p}weight_hh_l0{suffix}"]
        bias = w[f"{p}bias_ih_l0{suffix}"] + w[f"{p}bias_hh_l0{suffix}"]
        gates_x = A.linear(x, w_ih, bias)
        h = x.new_zeros(b, H)
        c = x.new_zeros(b, H)
        hs = [None] * L
        for t in steps:
            live = (t < lengths).float()[:, None]
            i, f, g, o = (gates_x[:, t] + A.linear(h, w_hh)).chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            h = live * h_new + (1 - live) * h
            c = live * c_new + (1 - live) * c
            hs[t] = h * live
        out.append(torch.stack(hs, 1))
    return torch.cat(out, -1)


def single_query(q, k, v, scale, mask=None):
    """q (N, C) over k (N, S, C) and v (N, S, Cv): the logits less 1e8 where
    masked, then scaled, softmax over S."""
    logits = torch.einsum("nc,nsc->ns", q, k)
    if mask is not None:
        logits = logits - mask.float() * 1e8
    return torch.einsum("ns,nsc->nc", torch.softmax(logits * scale, 1), v)


def policy(A: Arith, w, rgb_f, depth_f, ids, masks, hidden):
    """Velocities (B, T, 2), stop logits (B, T, 1) and the new hidden state
    (4, B, H) = [h1, c1, h2, c2]."""
    b, t = masks.shape
    n = b * t
    lengths = (ids != 0).sum(1)
    ins = bi_lstm(A, w, "instruction_encoder.encoder_rnn.",
                  w["instruction_encoder.embedding_layer.weight"][ids.long()], lengths)
    pads = (ins == 0).all(-1)  # (B, L)
    pooled = F.adaptive_avg_pool2d(rgb_f.permute(0, 3, 1, 2), (4, 4))
    rgb_tok = pooled.permute(0, 2, 3, 1).reshape(n, 16, -1)
    rgb_tok = torch.cat([rgb_tok, scrambled(w["rgb_encoder.spatial_embeddings.weight"])
                         .expand(n, -1, -1)], -1)
    depth_tok = depth_f.reshape(n, -1, depth_f.shape[-1])
    depth_tok = torch.cat([depth_tok, scrambled(w["depth_encoder.spatial_embeddings.weight"])
                           .expand(n, -1, -1)], -1)
    rgb_in = F.relu(_lin(A, w, "rgb_linear.2", rgb_tok.mean(1)))
    depth_in = F.relu(_lin(A, w, "depth_linear.1", depth_tok.transpose(1, 2).reshape(n, -1)))
    state, h1 = _lstm(A, w, "state_encoder.rnn", torch.cat([rgb_in, depth_in], 1)
                      .reshape(b, t, -1), hidden[:2], masks)
    state = state.reshape(n, -1)
    half = state.shape[1] // 2
    scale = 1.0 / math.sqrt(half)
    ins_n = ins[:, None].expand(b, t, *ins.shape[1:]).reshape(n, *ins.shape[1:])
    pads_n = pads[:, None].expand(b, t, -1).reshape(n, -1)
    text_k = A.linear(ins_n, w["text_k.weight"][:, :, 0], w["text_k.bias"])
    text = single_query(_lin(A, w, "state_q", state), text_k, ins_n, scale, pads_n)
    rgb_kv = A.linear(rgb_tok, w["rgb_kv.weight"][:, :, 0], w["rgb_kv.bias"])
    depth_kv = A.linear(depth_tok, w["depth_kv.weight"][:, :, 0], w["depth_kv.bias"])
    text_q = _lin(A, w, "text_q", text)
    rgb_att = single_query(text_q, rgb_kv[..., :half], rgb_kv[..., half:], scale)
    depth_att = single_query(text_q, depth_kv[..., :half], depth_kv[..., half:], scale)
    x = F.relu(_lin(A, w, "second_state_compress.0",
                    torch.cat([state, text, rgb_att, depth_att], 1))).reshape(b, t, -1)
    out, h2 = _lstm(A, w, "second_state_encoder.rnn", x, hidden[2:], masks)
    return _lin(A, w, "linear", out), _lin(A, w, "stop_linear", out), torch.cat([h1, h2])


class Reference:
    """The CMA train step over a copy of ``weights``; Adam with no weight
    decay.  ``sizes`` is unused here (the widths are the weights')."""

    def __init__(self, weights, sizes, precision="float32", dropout_seed=None):
        self.A = Arith(precision)
        self.frozen = {k: v for k, v in weights.items() if not trainable(k)}
        self.params = {k: v.detach().clone().float() for k, v in weights.items() if trainable(k)}
        self.opt = Adam()
        self.hidden = None
        self.steps = 0

    def step(self, batch, lr, _unused=None, ranks=1):
        A = self.A
        masks = batch["not_done_masks"].float()
        b, t = masks.shape
        if self.hidden is None:
            H = self.params["state_encoder.rnn.weight_hh_l0"].shape[1]
            self.hidden = torch.zeros(4, b, H, device=masks.device)
        with exact_float32(), A.scope():
            with torch.no_grad():
                rgb = batch["rgb"].flatten(0, 1)
                depth = batch["depth"].flatten(0, 1)
                rgb_f = torch.cat([tv_resnet50(A, self.frozen, "rgb_encoder.cnn.",
                                               rgb[i:i + TRUNK_BLOCK])
                                   for i in range(0, rgb.shape[0], TRUNK_BLOCK)])
                depth_f = torch.cat([gn_resnet50(A, self.frozen, "depth_encoder.visual_encoder.",
                                                 depth[i:i + TRUNK_BLOCK])
                                     for i in range(0, depth.shape[0], TRUNK_BLOCK)])
            params = {k: v.detach().requires_grad_() for k, v in self.params.items()}
            actions, stop, hidden = policy(A, {**self.frozen, **params}, rgb_f, depth_f,
                                           batch["instruction"], masks, self.hidden)
            terms = {"action_loss": velocity_mse(actions.reshape(-1, 2),
                                                 batch["corrected_actions"].reshape(-1, 2)),
                     "stop_loss": stop_bce(stop.reshape(-1, 1), batch["oracle_stop"].reshape(-1, 1))}
            names = list(params)
            grads = torch.autograd.grad(sum(terms.values()), [params[k] for k in names],
                                        allow_unused=True)
        grads = {k: g for k, g in zip(names, grads) if g is not None}
        self.opt.step(self.params, grads, lr)
        self.hidden = hidden.detach()
        self.steps += 1
        return {k: v.detach() for k, v in terms.items()}, grads
