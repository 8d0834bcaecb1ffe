"""The flat family's GloVe instruction encoder (counterpart of
robo_vln_tpu/models/encoders/instruction.py).

:class:`InstructionEncoder` is the reference's (instruction_encoder.py:9-92):
an embedding table (``embedding_layer``, the GloVe table of
``embedding_file`` when that file exists, else learned from its random
start, as in the JAX package), then an LSTM or GRU, optionally
bidirectional, with packed-sequence semantics (``ops/rnn.length_masked_*``:
the valid tokens are the non-zero ids).  ``final_state_only`` returns the
last hidden state (B, H·dirs); otherwise the padded output sequence,
channel-major (B, H·dirs, L), the layout CMA's ``text_k`` reads, zero at
the pads.

The recurrence's parameters sit in an ``nn.LSTM`` / ``nn.GRU`` under
``encoder_rnn``, whose key names (``weight_ih_l0``, ``..._reverse``) are the
reference's.  :func:`run_rnn` runs ``encoder_rnn`` itself over a packed
sequence, on every device (cuDNN on the card): one call where a
length-masked scan is a Python loop of a few thousand launches a training
window.  Packing reads the lengths on the host, so a CUDA graph cannot hold
it (the on-device eval encodes outside its graph); a row of length 0, which
packing refuses, is packed as one token and zeroed after, and
``pad_packed_sequence`` gives the exact zeros at the pads that CMA's text
mask reads.  :func:`run_scan`, the same function by ``ops/rnn``'s
length-masked scans, is the reference the packed path is held to.

The table trains, as the JAX package's Adam trains it: its flax parameter
is ``instruction_encoder/embedding``, which no frozen module name matches,
so the port's ``embedding_layer`` is exempt from that name's freeze
(``frozen_by_name``; training/optimizers.trainable_mask).  The reference
froze a loaded GloVe table.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ...ops.rnn import length_masked_gru, length_masked_lstm

RNN_TYPES = {"LSTM": nn.LSTM, "GRU": nn.GRU}


def load_glove_embeddings(path: str) -> Optional[np.ndarray]:
    """The GloVe table of embeddings.json.gz (instruction_encoder.py:55-68),
    or None when the file does not exist."""
    if not path or not os.path.exists(path):
        return None
    with gzip.open(path, "rt") as f:
        return np.asarray(json.load(f), np.float32)


def run_rnn(rnn: nn.RNNBase, x: torch.Tensor, lengths: torch.Tensor):
    """``rnn``'s weights over x (B, L, D) with packed-sequence semantics, by
    ``rnn``'s own forward over a packed sequence: (outs (B, L, H·dirs),
    final h (B, H·dirs), the forward direction's final c or None)."""
    L = x.shape[1]
    host = lengths.cpu()
    empty = host == 0
    packed = pack_padded_sequence(x, host.clamp(min=1), batch_first=True,
                                  enforce_sorted=False)
    out, state = rnn(packed)
    outs = pad_packed_sequence(out, batch_first=True, total_length=L)[0]
    h, c = state if rnn.mode == "LSTM" else (state, None)
    final = torch.cat(list(h), dim=-1)  # the directions' (B, H), forward first
    c_fwd = None if c is None else c[0]
    if empty.any():
        keep = (~empty).to(x.device)
        outs = outs * keep[:, None, None]
        final = final * keep[:, None]
        c_fwd = None if c_fwd is None else c_fwd * keep[:, None]
    return outs, final, c_fwd


def run_scan(rnn: nn.RNNBase, x: torch.Tensor, lengths: torch.Tensor):
    """:func:`run_rnn` by ops/rnn's length-masked scans: the reference it is
    held to."""
    outs, finals, c_fwd = [], [], None
    for suffix, reverse in (("", False), ("_reverse", True))[:1 + rnn.bidirectional]:
        w = {k: getattr(rnn, f"{k}_l0{suffix}") for k in
             ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        if rnn.mode == "LSTM":
            o, (h, c) = length_masked_lstm(x, lengths, w["weight_ih"].t(),
                                           w["weight_hh"].t(), w["bias_ih"] + w["bias_hh"],
                                           reverse=reverse)
            c_fwd = c if c_fwd is None else c_fwd
        else:
            o, h = length_masked_gru(x, lengths, w["weight_ih"].t(), w["weight_hh"].t(),
                                     w["bias_ih"], w["bias_hh"], reverse=reverse)
        outs.append(o)
        finals.append(h)
    return torch.cat(outs, dim=-1), torch.cat(finals, dim=-1), c_fwd


def token_lengths(instruction: torch.Tensor) -> torch.Tensor:
    """Valid tokens a row: the non-zero ids (0 pads)."""
    return (instruction != 0).sum(dim=1)


class InstructionEncoder(nn.Module):
    def __init__(self, vocab_size: int = 2504, embedding_size: int = 50,
                 hidden_size: int = 256, rnn_type: str = "LSTM",
                 final_state_only: bool = True, bidirectional: bool = False):
        super().__init__()
        self.final_state_only = final_state_only
        self.embedding_layer = nn.Embedding(vocab_size, embedding_size)
        self.embedding_layer.frozen_by_name = False
        self.encoder_rnn = RNN_TYPES[rnn_type](embedding_size, hidden_size,
                                               batch_first=True, bidirectional=bidirectional)
        self.output_size = hidden_size * (2 if bidirectional else 1)

    @torch.no_grad()
    def load_table(self, table: np.ndarray) -> None:
        self.embedding_layer.weight.copy_(torch.from_numpy(table))

    def forward(self, instruction: torch.Tensor) -> torch.Tensor:
        """instruction (B, L) int token ids, 0 = pad."""
        ids = instruction.long()
        outs, final, _ = run_rnn(self.encoder_rnn, self.embedding_layer(ids),
                                 token_lengths(ids))
        if self.final_state_only:
            return final
        return outs.transpose(1, 2)
