"""Trajectory dataset: block-shuffled reads, stop relabeling, static-shape
bucketed collation (the port's own copy of robo_vln_tpu/data/loader.py; the
same seed gives the same episode order and bitwise the same batches).

Re-implements the reference IWTrajectoryDataset + collate_fn pipeline
(robo_vln_trainer.py:67-291) with the JAX package's one deliberate change:
instead of padding each batch to its max episode length, episodes are
padded up to a fixed LENGTH BUCKET.  With the default buckets (multiples of
tbptt_steps=100) every TBPTT window has the same shape.

Preserved semantics (SURVEY.md §7 "oddities"):
  * length-bucketed block shuffle: preload batches of B*100 episodes, sort by
    length with random tiebreak, block-shuffle in blocks of B (:207-241);
  * stop relabeling: sub-goals from step stop_step-1 onward become class 4 and
    oracle_stop 1 (:243-252);
  * instruction: single row per episode — BERT wordpiece ids or GloVe ids;
  * collate: not_done_masks all ones except t=0 (:141-142); oracle_stop padded
    with -1; actions/observations padded with 0.

Batches come out batch-major: obs (B,T,...), instruction (B,L) — the batch
axis is axis 0 everywhere.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import serialization
from .trajectory_store import TrajectoryStore

# Canonical storage/transfer dtypes for the image sensors, applied in the
# collection buffer AND in collate: rgb stays uint8 end to end (the reference
# materializes float32 at collate, robo_vln_trainer.py:119-131 — 4x the bytes
# over the wire; a B=8,T=100 224x224 window is ~480 MB of rgb as f32, ~120 MB
# as uint8), depth rides as float16 (values in [0,1]; rounding is below
# sensor noise).  The /255 and the cast to the compute dtype happen on the
# device, in the encoders.
SENSOR_DTYPES = {
    "rgb": np.uint8,
    "depth": np.float16,
    # precomputed frozen-trunk outputs (training/featurize.py feature-store
    # training mode)
    "rgb_features": np.float16,
    "depth_features": np.float16,
}


def block_shuffle(lst: List, block_size: int, rng: random.Random) -> List:
    """Shuffle blocks of `block_size` keeping intra-block order
    (reference _block_shuffle, robo_vln_trainer.py:169-173)."""
    blocks = [lst[i : i + block_size] for i in range(0, len(lst), block_size)]
    rng.shuffle(blocks)
    return [x for b in blocks for x in b]


def pack_episode(obs: Dict[str, np.ndarray], prev_actions: np.ndarray,
                 corrected_actions: np.ndarray,
                 stop_step: Sequence[int]) -> bytes:
    """Serialize one expert episode in the reference's transposed_ep layout
    (robo_vln_trainer.py:479-488) — the unit shipped from collection workers
    to the buffer writer.  msgpack wire format (reference-compatible)."""
    return serialization.packb(
        [dict(obs), np.asarray(prev_actions, np.float64),
         np.asarray(corrected_actions, np.float64), list(map(int, stop_step))]
    )


def pack_episode_flat(obs: Dict[str, np.ndarray], prev_actions: np.ndarray,
                      corrected_actions: np.ndarray,
                      stop_step: Sequence[int]) -> bytes:
    """Same episode layout in the zero-copy flat format (serialization
    pack_flat) — the internal feature-store encoding: decode is header-parse
    only, arrays come back as views (the 1-core host's decode bandwidth is
    the limiter at large device batches, docs/ROUND3.md)."""
    return serialization.pack_flat(
        [dict(obs), np.asarray(prev_actions, np.float64),
         np.asarray(corrected_actions, np.float64), list(map(int, stop_step))]
    )


def write_episode(store: TrajectoryStore, key: int, obs: Dict[str, np.ndarray],
                  prev_actions: np.ndarray, corrected_actions: np.ndarray,
                  stop_step: Sequence[int], flat: bool = False) -> None:
    pack = pack_episode_flat if flat else pack_episode
    store.put(key, pack(obs, prev_actions, corrected_actions, stop_step))


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class TrajectoryDataset:
    """Iterator over decoded, relabeled episodes in block-shuffled order."""

    def __init__(
        self,
        features_dir: str,
        batch_size: int = 1,
        is_bert: bool = False,
        use_iw: bool = True,
        inflection_weight_coef: float = 1.0,
        seed: int = 0,
        indices: Optional[Sequence[int]] = None,
    ):
        self.features_dir = features_dir
        self.batch_size = batch_size
        self.preload_size = batch_size * 100
        self.is_bert = is_bert
        self.inflec_weights = np.array(
            [1.0, inflection_weight_coef if use_iw else 1.0], np.float32
        )
        self._rng = random.Random(seed)
        if indices is None:
            with TrajectoryStore(features_dir) as store:
                indices = range(len(store))
        # episode-key subset: the process-parallel loader gives each worker a
        # disjoint round-robin shard (data/parallel_loader.py)
        self.indices = list(indices)
        self.length = len(self.indices)

    def _decode(self, raw):
        """Decode one packed episode (bytes or uint8 buffer, either wire
        format).  Flat-format arrays come back as zero-copy views into `raw`
        — they are read-only and copied exactly once, into the collated
        batch."""
        obs, prev_actions, oracle_actions, stop_step = (
            serialization.unpackb_any(raw)
        )
        prev_actions = np.asarray(prev_actions, np.float32).reshape(-1, 2)
        oracle_actions = np.asarray(oracle_actions, np.float32).reshape(-1, 2)

        discrete = np.asarray(obs["vln_oracle_action_sensor"]).reshape(-1).copy()
        val = int(np.asarray(stop_step).reshape(-1)[-1]) - 1
        discrete[val:] = 4
        oracle_stop = np.zeros_like(discrete, np.float32)
        oracle_stop[val:] = 1.0

        out = {k: np.asarray(v) for k, v in obs.items()}
        out["vln_oracle_action_sensor"] = discrete
        if self.is_bert:
            instruction = np.asarray(out["instruction"]).reshape(
                len(prev_actions), -1
            )[0]
            # the per-step GloVe id rows ride in the buffer for GloVe-side
            # training (obs_utils.transform_obs); they are episode-level and
            # variable-length, so they must never reach the per-step sensor
            # collate (mixed instruction lengths break its static shapes)
            out.pop("glove_tokens", None)
        else:
            # buffers collected with is_bert=True carry BOTH id types
            # (robovln_data_train.yaml sets is_bert: True; transform_obs keeps
            # the GloVe ids as glove_tokens) — fall back to `instruction` for
            # buffers collected GloVe-only
            key = "glove_tokens" if "glove_tokens" in out else "instruction"
            instruction = np.asarray(out[key]).reshape(len(prev_actions), -1)[0]
            out.pop("glove_tokens", None)
        out["instruction"] = instruction  # (L,) single row per episode
        return out, prev_actions, oracle_actions, oracle_stop

    def __iter__(self) -> Iterator:
        order = block_shuffle(list(self.indices), self.preload_size, self._rng)
        order = list(reversed(order))
        store = TrajectoryStore(self.features_dir)
        try:
            while order:
                chunk = []
                lengths = []
                for _ in range(self.preload_size):
                    if not order:
                        break
                    chunk.append(self._decode(store.get_buffer(order.pop())))
                    lengths.append(len(chunk[-1][1]))
                tiebreak = list(range(len(lengths)))
                self._rng.shuffle(tiebreak)
                idx = sorted(
                    range(len(lengths)), key=lambda k: (lengths[k], tiebreak[k])
                )
                for i in block_shuffle(idx, self.batch_size, self._rng):
                    yield chunk[i]
        finally:
            store.close()


def _empty_alloc(key: str, shape, dtype) -> np.ndarray:
    del key
    return np.empty(shape, dtype)


def collate_batch(
    samples: List,
    buckets: Sequence[int],
    max_instruction_len: int = 200,
    pad_to_batch: Optional[int] = None,
    alloc=_empty_alloc,
    rows: Optional[Tuple[int, int]] = None,
) -> Dict[str, np.ndarray]:
    """Pad a list of decoded episodes into one static-shape batch-major batch.

    `pad_to_batch` pads the BATCH axis with empty episodes (valid_mask=0,
    corrected_actions=0, oracle_stop=-1, oracle sub-goal 0) so tail batches
    keep the compiled shape on a full device mesh; every loss masks them out
    (ops/losses.py).

    `alloc(key, shape, dtype)` provides the destination arrays for the LARGE
    per-step tensors (frames/features + instruction_embedding) — the
    process-parallel loader passes a shared-memory allocator so workers
    collate straight into the segment the trainer reads.  Only the padding
    tail is zeroed (the real rows are fully overwritten), which saves a full
    memset pass over the dominant arrays on the hot path.

    `rows=(lo, hi)` collates only rows [lo, hi) of that batch, at the
    bucket of all of `samples`: a rank of the data-parallel mesh collates
    its own rows of the global batch (parallel/mesh.DataMesh.rows)."""
    B = max(len(samples), pad_to_batch or 0)
    T = pick_bucket(max(len(s[1]) for s in samples), buckets)
    L = max_instruction_len

    obs0 = samples[0][0]
    if rows is not None:
        lo, hi = rows
        samples, B = samples[lo:hi], hi - lo
    batch: Dict[str, np.ndarray] = {}
    # episode-level (not per-step) keys; instruction_embedding is the
    # precomputed frozen-BERT row from the feature store (training/featurize.py)
    episode_keys = ("instruction", "instruction_embedding")
    sensor_keys = [k for k in obs0 if k not in episode_keys]
    for k in sensor_keys:
        arr0 = np.asarray(obs0[k])
        shape = (B, T) + arr0.shape[1:]
        out = alloc(k, shape, SENSOR_DTYPES.get(k, np.float32))
        for b, s in enumerate(samples):
            v = np.asarray(s[0][k])
            n = min(len(v), T)
            out[b, :n] = v[:T]  # cast-on-assign for legacy f64 buffers
            if n < T:
                out[b, n:] = 0
        if len(samples) < B:
            out[len(samples):] = 0
        batch[k] = out

    instruction = np.zeros((B, L), np.int32)
    for b, s in enumerate(samples):
        ids = np.asarray(s[0]["instruction"]).reshape(-1)[:L]
        instruction[b, : len(ids)] = ids
    batch["instruction"] = instruction

    if "instruction_embedding" in obs0:
        D = np.asarray(obs0["instruction_embedding"]).shape[-1]
        emb = alloc("instruction_embedding", (B, L, D), np.float16)
        for b, s in enumerate(samples):
            e = np.asarray(s[0]["instruction_embedding"])[:L]
            emb[b, : len(e)] = e
            if len(e) < L:
                emb[b, len(e):] = 0
        if len(samples) < B:
            emb[len(samples):] = 0
        batch["instruction_embedding"] = emb

    prev_actions = np.zeros((B, T, 2), np.float32)
    corrected = np.zeros((B, T, 2), np.float32)
    oracle_stop = np.full((B, T, 1), -1.0, np.float32)
    valid = np.zeros((B, T), np.float32)
    for b, s in enumerate(samples):
        _, pa, oa, ostop = s
        n = min(len(pa), T)
        prev_actions[b, :n] = pa[:n]
        corrected[b, :n] = oa[:n]
        oracle_stop[b, :n, 0] = ostop[:n]
        valid[b, :n] = 1.0

    not_done = np.ones((B, T), np.float32)
    not_done[:, 0] = 0.0  # hidden reset at batch start (collate_fn :141-142)

    batch["prev_actions"] = prev_actions
    batch["corrected_actions"] = corrected
    batch["oracle_stop"] = oracle_stop
    batch["not_done_masks"] = not_done
    batch["valid_mask"] = valid  # 1 on real steps, 0 on padding
    return batch


def batch_iterator(
    dataset: TrajectoryDataset,
    batch_size: int,
    buckets: Sequence[int],
    max_instruction_len: int = 200,
    drop_last: bool = False,
    rows: Optional[Tuple[int, int]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield static-shape batches of exactly `batch_size` episodes; the tail
    batch is padded with empty (fully masked) episodes rather than dropped, so
    a full-mesh global batch never starves on small buffers.  `rows` keeps
    rows [lo, hi) of each batch (collate_batch)."""
    buf = []
    for sample in dataset:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate_batch(buf, buckets, max_instruction_len, rows=rows)
            buf = []
    if buf and not drop_last:
        yield collate_batch(
            buf, buckets, max_instruction_len, pad_to_batch=batch_size,
            rows=rows,
        )


def split_tbptt(batch: Dict[str, np.ndarray], tbptt_steps: int):
    """Chunk a (B,T,...) batch into tbptt windows along time (reference
    split_batch_tbptt, common/utils.py:120-144). Instruction (B,L) is shared
    across windows."""
    T = batch["prev_actions"].shape[1]
    for s in range(0, T, tbptt_steps):
        e = min(s + tbptt_steps, T)
        yield {
            k: (v if k in ("instruction", "instruction_embedding")
                else v[:, s:e])
            for k, v in batch.items()
        }
