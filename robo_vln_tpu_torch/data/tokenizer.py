"""Instruction tokenization (host-side); the port's own copy of
robo_vln_tpu/data/tokenizer.py.

The reference tokenizes instruction text with
``BertWordPieceTokenizer(vocab_file, lowercase=True)`` at env-step time
(common/utils.py:104-111) and falls back to dataset-provided GloVe token ids.
Here tokenization is a pure host-side preprocessing step with two backends:

* :class:`WordPieceTokenizer` — self-contained BERT-style basic+wordpiece
  tokenizer (lowercase, accent-strip, punctuation split, greedy
  longest-match-first with ``##`` continuations, [CLS]/[SEP] post-processing)
  validated against the HF ``tokenizers`` implementation in tests;
* if the HF ``tokenizers`` package is importable it is used directly for
  bit-identical ids with the reference.

Outputs are fixed-length int32 arrays padded to MAX_INSTRUCTION_LEN (the
reference caps at 200, config/default.py:100).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out: List[str] = []
    word = []
    for ch in text:
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif _is_punctuation(ch):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class WordPieceTokenizer:
    """BERT wordpiece encoder compatible with BertWordPieceTokenizer output:
    ids = [CLS] + wordpieces + [SEP]."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.lowercase = lowercase
        self.unk_id = vocab.get("[UNK]", 1)
        self.cls_id = vocab.get("[CLS]", 2)
        self.sep_id = vocab.get("[SEP]", 3)
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True):
        vocab = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, lowercase)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        ids = [self.cls_id]
        for word in _basic_tokenize(text, self.lowercase):
            ids.extend(self._wordpiece(word))
        ids.append(self.sep_id)
        return ids


class InstructionTokenizer:
    """End-to-end instruction -> fixed-length id array.

    is_bert=True: wordpiece ids over a BERT vocab file (the HCM path).
    is_bert=False: the dataset's precomputed GloVe token ids pass through
    (reference transform_obs else-branch, utils.py:113-116).
    """

    def __init__(self, vocab_file: Optional[str] = None, max_len: int = 200,
                 lowercase: bool = True, prefer_hf: bool = True):
        self.max_len = max_len
        self._hf = None
        self._own: Optional[WordPieceTokenizer] = None
        if vocab_file:
            if prefer_hf:
                try:
                    from tokenizers import BertWordPieceTokenizer

                    self._hf = BertWordPieceTokenizer(vocab_file, lowercase=lowercase)
                except Exception:
                    self._hf = None
            if self._hf is None:
                self._own = WordPieceTokenizer.from_vocab_file(vocab_file, lowercase)

    def encode(self, text: str) -> np.ndarray:
        if self._hf is not None:
            ids = self._hf.encode(text).ids
        elif self._own is not None:
            ids = self._own.encode(text)
        else:
            raise ValueError("No vocab file configured for BERT tokenization")
        return self.pad(ids)

    def pad(self, ids) -> np.ndarray:
        out = np.zeros(self.max_len, np.int32)
        ids = list(ids)[: self.max_len]
        out[: len(ids)] = ids
        return out
