"""The Seq2Seq policy's BERT instruction encoder (counterpart of
robo_vln_tpu/models/encoders/language.py; the reference's
language_encoder.py:11-137, which Seq2SeqNet takes when
INSTRUCTION_ENCODER.is_bert).

BERT (``embedding_layer``, frozen unless ``MODEL.BERT.trainable``, and then
run under ``no_grad``), embedding dropout at ``dropout_ratio`` in training
(given a generator, as models/transformer.dropout draws it), then the
packed (bi)LSTM or GRU of ``encoder_rnn`` (models/encoders/instruction.py's
``run_rnn``).  ``final_state_only`` returns h_T (B, H·dirs); otherwise
(outs (B, L, H·dirs), (tanh(encoder2decoder(h_T)), c_T)).  The reference
builds ``encoder2decoder`` in either mode, so it is built here too and only
the full-sequence mode reads it (the flax module creates it only there).
"""

from __future__ import annotations

import torch
from torch import nn

from ..transformer import dropout
from .bert import BertEncoder
from .instruction import RNN_TYPES, run_rnn, token_lengths


class LanguageEncoder(nn.Module):
    def __init__(self, bert_config, hidden_size: int = 256, rnn_type: str = "LSTM",
                 final_state_only: bool = True, bidirectional: bool = False,
                 dropout_ratio: float = 0.25, compute_dtype=torch.float32):
        super().__init__()
        bc = self.bert_config = bert_config
        self.final_state_only = final_state_only
        self.dropout_ratio = dropout_ratio
        self.embedding_layer = BertEncoder(
            vocab_size=bc.vocab_size, hidden_size=bc.hidden_size,
            num_layers=bc.num_layers, num_heads=bc.num_heads,
            intermediate_size=bc.intermediate_size,
            max_position_embeddings=bc.max_position_embeddings,
            type_vocab_size=bc.type_vocab_size, compute_dtype=compute_dtype,
        )
        self.encoder_rnn = RNN_TYPES[rnn_type](bc.hidden_size, hidden_size,
                                               batch_first=True, bidirectional=bidirectional)
        self.output_size = hidden_size * (2 if bidirectional else 1)
        self.encoder2decoder = nn.Linear(self.output_size, self.output_size)

    def forward(self, instruction: torch.Tensor, generator=None):
        ids = instruction.long()
        if self.bert_config.trainable:
            embedded = self.embedding_layer(ids)
        else:
            with torch.no_grad():
                embedded = self.embedding_layer(ids)
        embedded = dropout(embedded, self.dropout_ratio, generator, self.training)
        outs, final, c_fwd = run_rnn(self.encoder_rnn, embedded, token_lengths(ids))
        if self.final_state_only:
            return final
        h_t = torch.tanh(self.encoder2decoder(final))
        return outs, (h_t, c_fwd)
