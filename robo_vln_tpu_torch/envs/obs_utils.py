"""Observation transforms and batching for the env-facing loops, the eval and
collection (the port's own copy of robo_vln_tpu/envs/obs_utils.py).

`transform_obs` swaps the instruction sensor dict for token ids (BERT
wordpiece ids via the tokenizer, keeping the GloVe ids as `glove_tokens`;
or, without a vocab file, the dataset's own ids), `batch_obs` stacks a
single observation dict into (1, ...) arrays for the single-step policy,
`batch_obs_data_collect` transposes a list of per-step observation dicts
into stacked (T, ...) arrays for the buffer.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..data.loader import SENSOR_DTYPES
from ..data.tokenizer import InstructionTokenizer


def make_tokenizer(config) -> Optional[InstructionTokenizer]:
    """The wordpiece tokenizer of BERT_VOCAB_FILE for the is_bert
    instruction path; None without a vocab file (the dataset's own ids are
    used) or on the GloVe path."""
    if not config.MODEL.INSTRUCTION_ENCODER.is_bert:
        return None
    vf = config.BERT_VOCAB_FILE
    return InstructionTokenizer(vf, max_len=config.DAGGER.MAX_INSTRUCTION_LEN) if vf else None


def transform_obs(observations: Dict, instruction_sensor_uuid: str,
                  tokenizer: Optional[InstructionTokenizer] = None,
                  is_bert: bool = False) -> Dict:
    ins = observations.get(instruction_sensor_uuid)
    if isinstance(ins, dict):
        if is_bert:
            observations["glove_tokens"] = np.asarray(
                ins.get("tokens") or [], np.float64
            )
            if tokenizer is not None:
                observations[instruction_sensor_uuid] = tokenizer.encode(
                    ins["text"]
                )
            else:
                # no BERT vocab file configured (BERT_VOCAB_FILE): fall back
                # to the dataset's token ids so the pipeline stays runnable;
                # pretrained-BERT parity requires the vocab file.
                observations[instruction_sensor_uuid] = np.asarray(
                    ins.get("tokens") or [0], np.float64
                )
        else:
            observations[instruction_sensor_uuid] = np.asarray(
                ins["tokens"], np.float64
            )
    return observations


def batch_obs(observations: Dict, pad_instruction_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One observation dict -> dict of (1, ...) arrays.  Images keep the
    compact transfer dtypes (rgb uint8, depth float16,
    data/loader.SENSOR_DTYPES); the encoders cast on the device.  The
    instruction is padded into float32 (its ids below 2^24 stay exact; the
    BERT embedding casts them to integers)."""
    out = {}
    for k, v in observations.items():
        arr = np.asarray(v, SENSOR_DTYPES.get(k, np.float32))
        if k == "instruction" and pad_instruction_to:
            padded = np.zeros(pad_instruction_to, np.float32)
            padded[: min(len(arr), pad_instruction_to)] = arr[:pad_instruction_to]
            arr = padded
        out[k] = arr[None]
    return out


def batch_obs_data_collect(observations: List[Dict]) -> Dict[str, np.ndarray]:
    """List of per-step obs dicts -> stacked (T, ...) arrays (reference
    utils.py:30-57).  Ragged instruction ids are right-padded to the max
    length first.  Unlike the reference, which casts every sensor to float32
    before the buffer write, images keep the compact dtypes of
    data/loader.SENSOR_DTYPES (rgb uint8, depth float16), about 4x fewer
    bytes in the buffer."""
    keys = observations[0].keys()
    out = {}
    for k in keys:
        dt = SENSOR_DTYPES.get(k, np.float32)
        vals = [np.asarray(o[k]).astype(dt, copy=False) for o in observations]
        if vals[0].ndim >= 1 and len({v.shape for v in vals}) > 1:
            max_len = max(v.shape[-1] for v in vals)
            vals = [
                np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, max_len - v.shape[-1])])
                for v in vals
            ]
        out[k] = np.stack(vals, axis=0)
    return out
