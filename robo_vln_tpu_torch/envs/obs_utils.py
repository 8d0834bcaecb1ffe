"""Observation transforms and batching for the eval loop (the port's own copy
of ``transform_obs`` and ``batch_obs`` of robo_vln_tpu/envs/obs_utils.py;
``batch_obs_data_collect`` comes with collection, ROADMAP §A item 5).

`transform_obs` swaps the instruction sensor dict for token ids (BERT
wordpiece ids via the tokenizer, keeping the GloVe ids as `glove_tokens`;
or, without a vocab file, the dataset's own ids), `batch_obs` stacks a
single observation dict into (1, ...) arrays for the single-step policy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..data.loader import SENSOR_DTYPES
from ..data.tokenizer import InstructionTokenizer


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
