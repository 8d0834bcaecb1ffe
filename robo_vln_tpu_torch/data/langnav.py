"""LangNav: synthetic compositional instruction-grounding episodes (a
numpy-only copy of robo_vln_tpu/data/langnav.py; the same seeds give the
same splits, word ids included).

Generates robo_vln_v1-format datasets (data/dataset.py's schema) where the
instruction is a *program* in a tiny English grammar and the reference path
is derived from it:

    "walk forward two meters then turn left and walk three meters then stop"

Because path <-> instruction is a bijection (fixed start pose), a policy can
in principle ground unseen instruction *compositions* into closed-loop control
— which makes held-out-split metric improvement measurable on the renderless
kinematic backend (robo_vln_tpu_torch/scripts/convergence_study.py).  It
stands in for the real robo_vln data in the study; it is NOT a claim of R2R
parity.

Conventions match the kinematic sim (envs/velocity_control.py): heading h has
forward (-sin h, 0, -cos h); positive angular velocity around +y turns LEFT.
Episodes start at the origin facing heading 0 so the instruction fully
determines the trajectory.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# (phrase, heading delta) — positive = left (envs/velocity_control.py)
TURNS: List[Tuple[str, float]] = [
    ("go straight", 0.0),
    ("turn slightly left", np.pi / 4),
    ("turn left", np.pi / 2),
    ("turn slightly right", -np.pi / 4),
    ("turn right", -np.pi / 2),
]
LENGTH_WORDS = {1: "one", 2: "two", 3: "three", 4: "four", 5: "five"}

# deterministic word->id map; ids start at 100 so they never collide with
# special ids (0 = pad everywhere in the data plane)
VOCAB: List[str] = sorted(
    {"walk", "forward", "meters", "then", "and", "stop"}
    | {w for phrase, _ in TURNS for w in phrase.split()}
    | set(LENGTH_WORDS.values())
)
WORD_TO_ID: Dict[str, int] = {w: 100 + i for i, w in enumerate(VOCAB)}

Program = Tuple[Tuple[int, int], ...]  # ((turn_idx, length_m), ...)


def word_ids(text: str) -> List[int]:
    return [WORD_TO_ID[w] for w in text.split()]


def sample_program(
    rng: np.random.Generator, n_segments: int,
    lengths: Sequence[int] = (2, 3, 4),
) -> Program:
    segs = []
    for k in range(n_segments):
        # first segment has no turn (agent starts already facing forward)
        turn = 0 if k == 0 else int(rng.integers(0, len(TURNS)))
        segs.append((turn, int(rng.choice(list(lengths)))))
    return tuple(segs)


def program_to_instruction(program: Program) -> str:
    parts = []
    for k, (turn, length) in enumerate(program):
        move = f"walk forward {LENGTH_WORDS[length]} meters"
        if k == 0:
            parts.append(move)
        elif TURNS[turn][0] == "go straight":
            parts.append(f"then go straight and {move}")
        else:
            parts.append(f"then {TURNS[turn][0]} and {move}")
    parts.append("then stop")
    return " ".join(parts)


def program_to_path(program: Program) -> List[List[float]]:
    """Waypoints (segment endpoints) in habitat world coords, start at origin
    facing heading 0 (toward -z)."""
    pos = np.zeros(3)
    heading = 0.0
    pts = [pos.tolist()]
    for turn, length in program:
        heading += TURNS[turn][1]
        pos = pos + length * np.array(
            [-np.sin(heading), 0.0, -np.cos(heading)]
        )
        pts.append([float(pos[0]), 0.0, float(pos[2])])
    return pts


def path_length(path: List[List[float]]) -> float:
    p = np.asarray(path)
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())


def densify_path(path: List[List[float]], spacing: float = 0.25
                 ) -> List[List[float]]:
    """Resample the waypoint polyline at ~`spacing` m — the ground-truth
    trajectory for nDTW/SDTW gt files.

    VLN-CE's {split}_gt.json.gz stores the discrete oracle's actual step
    locations (~0.25 m apart); the reference evaluates its 30 Hz continuous
    agent paths against those (hierarchical_trainer.py:1086-1135), so the
    published nDTW scale assumes a gt of this density.  DTW against the raw
    sparse waypoints instead accumulates one inter-waypoint-scale term per
    agent step, driving nDTW to ~0 even for a perfect rollout."""
    p = np.asarray(path, np.float64)
    out = [p[0]]
    for a, b in zip(p[:-1], p[1:]):
        seg = np.linalg.norm(b - a)
        n = max(int(np.ceil(seg / spacing)), 1)
        for k in range(1, n + 1):
            out.append(a + (b - a) * (k / n))
    return [[float(x) for x in q] for q in out]


def make_episode(
    episode_id: str, scene_id: str, program: Program,
    goal_radius: float = 1.0,
) -> dict:
    path = program_to_path(program)
    text = program_to_instruction(program)
    return {
        "episode_id": episode_id,
        "scene_id": scene_id,
        "start_position": path[0],
        "start_rotation": [0.0, 0.0, 0.0, 1.0],
        "goals": [{"position": path[-1], "radius": goal_radius}],
        "reference_path": path,
        "instruction": {
            "instruction_text": text,
            "instruction_tokens": word_ids(text),
        },
        # geodesic = along-instruction distance (the kinematic backend's
        # polyline geodesics agree with this)
        "info": {"geodesic_distance": path_length(path)},
    }


def generate_splits(
    out_dir: str,
    n_train: int = 64,
    n_val_unseen: int = 12,
    n_val_seen: Optional[int] = None,
    seed: int = 0,
    n_segments: Sequence[int] = (2, 3),
    lengths: Sequence[int] = (2, 3, 4),
    scenes: int = 4,
) -> Dict[str, str]:
    """Write {split}/{split}.json.gz for train / val_seen / val_unseen.

    val_seen   = first n_val_seen training episodes (reference semantics:
                 same environments/instructions seen in training).
    val_unseen = freshly sampled programs disjoint from every train program.
    """
    rng = np.random.default_rng(seed)
    n_val_seen = n_val_seen if n_val_seen is not None else n_val_unseen

    train_programs: List[Program] = []
    seen = set()
    while len(train_programs) < n_train:
        p = sample_program(rng, int(rng.choice(list(n_segments))), lengths)
        if p not in seen:
            seen.add(p)
            train_programs.append(p)
    unseen_programs: List[Program] = []
    while len(unseen_programs) < n_val_unseen:
        p = sample_program(rng, int(rng.choice(list(n_segments))), lengths)
        if p not in seen:
            seen.add(p)
            unseen_programs.append(p)

    def episodes(programs, scene_pool):
        return [
            make_episode(str(i), f"langnav_{scene_pool[i % len(scene_pool)]}.glb", p)
            for i, p in enumerate(programs)
        ]

    train_scenes = [chr(ord("A") + s) for s in range(scenes)]
    splits = {
        "train": episodes(train_programs, train_scenes),
        "val_seen": episodes(train_programs[:n_val_seen], train_scenes),
        "val_unseen": episodes(unseen_programs, ["U", "V"]),
    }
    paths = {}
    for split, eps in splits.items():
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{split}.json.gz")
        with gzip.open(path, "wt") as f:
            json.dump(
                {"episodes": eps,
                 "instruction_vocab": {"word_list": ["<pad>"] + VOCAB}},
                f,
            )
        # VLN-CE-style dense ground-truth trajectories for nDTW/SDTW
        # (TASK.NDTW.GT_PATH); see densify_path for why density matters
        with gzip.open(os.path.join(d, f"{split}_gt.json.gz"), "wt") as f:
            json.dump(
                {e["episode_id"]: {
                    "locations": densify_path(e["reference_path"]),
                    "actions": [],
                 } for e in eps},
                f,
            )
        paths[split] = path
    return paths
