"""robo_vln_v1 episode dataset (host-side); the port's own copy of
robo_vln_tpu/data/dataset.py.

Equivalent of reference VLNCEDatasetV1
(the reference's habitat_extensions/task.py:19-99) without the habitat
dependency: loads gzipped episode JSON ({"episodes": [...],
"instruction_vocab": {"word_list": [...]}}), applies scene filtering, exposes
`get_scenes_to_load`.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ALL_SCENES_MASK = "*"
DEFAULT_SCENE_PATH_PREFIX = "data/scene_datasets/"


@dataclass
class NavigationGoal:
    position: List[float]
    radius: Optional[float] = None


@dataclass
class InstructionData:
    instruction_text: str
    instruction_tokens: Optional[List[int]] = None
    instruction_id: Optional[str] = None


@dataclass
class VLNEpisode:
    episode_id: str
    scene_id: str
    start_position: List[float]
    start_rotation: List[float]
    goals: List[NavigationGoal]
    instruction: InstructionData
    reference_path: List[List[float]] = field(default_factory=list)
    info: Dict[str, Any] = field(default_factory=dict)
    trajectory_id: Optional[Any] = None
    instruction_index_string: Optional[str] = None
    extras: Dict[str, Any] = field(default_factory=dict)


class VocabDict:
    """word <-> id mapping (habitat VocabDict subset used by the dataset)."""

    def __init__(self, word_list: List[str]):
        self.word_list = list(word_list)
        self.word2idx_dict = {w: i for i, w in enumerate(self.word_list)}
        self.UNK = "<unk>"

    def word2idx(self, word: str) -> int:
        if word in self.word2idx_dict:
            return self.word2idx_dict[word]
        if self.UNK in self.word2idx_dict:
            return self.word2idx_dict[self.UNK]
        return 1

    def __len__(self):
        return len(self.word_list)


class VLNCEDatasetV1:
    episodes: List[VLNEpisode]
    instruction_vocab: Optional[VocabDict]

    def __init__(self, config=None, data_path: Optional[str] = None,
                 scenes_dir: Optional[str] = None,
                 content_scenes: Optional[List[str]] = None):
        self.episodes = []
        self.instruction_vocab = None
        if config is not None:
            data_path = config.DATA_PATH.format(split=config.SPLIT)
            scenes_dir = config.SCENES_DIR
            content_scenes = list(config.CONTENT_SCENES)
        if data_path is None:
            return
        with gzip.open(data_path, "rt") as f:
            self.from_json(f.read(), scenes_dir=scenes_dir)
        if content_scenes and ALL_SCENES_MASK not in content_scenes:
            keep = set(content_scenes)
            self.episodes = [
                e for e in self.episodes if self._scene_from_episode(e) in keep
            ]

    @staticmethod
    def _scene_from_episode(episode: VLNEpisode) -> str:
        return os.path.splitext(os.path.basename(episode.scene_id))[0]

    @classmethod
    def get_scenes_to_load(cls, config) -> List[str]:
        dataset = cls(config=config)
        return sorted({cls._scene_from_episode(e) for e in dataset.episodes})

    def from_json(self, json_str: str, scenes_dir: Optional[str] = None) -> None:
        deserialized = json.loads(json_str)
        if "instruction_vocab" in deserialized:
            self.instruction_vocab = VocabDict(
                deserialized["instruction_vocab"]["word_list"]
            )
        known = {
            "episode_id", "scene_id", "start_position", "start_rotation",
            "goals", "instruction", "reference_path", "info", "trajectory_id",
            "instruction_index_string",
        }
        for ep in deserialized["episodes"]:
            extras = {k: v for k, v in ep.items() if k not in known}
            scene_id = ep["scene_id"]
            if scenes_dir is not None:
                if scene_id.startswith(DEFAULT_SCENE_PATH_PREFIX):
                    scene_id = scene_id[len(DEFAULT_SCENE_PATH_PREFIX):]
                scene_id = os.path.join(scenes_dir, scene_id)
            goals = [
                NavigationGoal(
                    position=g["position"], radius=g.get("radius")
                )
                for g in ep.get("goals") or []
            ]
            ins = ep["instruction"]
            instruction = InstructionData(
                instruction_text=ins.get("instruction_text", ""),
                instruction_tokens=ins.get("instruction_tokens"),
                instruction_id=ins.get("instruction_id"),
            )
            self.episodes.append(
                VLNEpisode(
                    episode_id=str(ep["episode_id"]),
                    scene_id=scene_id,
                    start_position=ep["start_position"],
                    start_rotation=ep["start_rotation"],
                    goals=goals,
                    instruction=instruction,
                    reference_path=ep.get("reference_path", []),
                    info=ep.get("info", {}),
                    trajectory_id=ep.get("trajectory_id"),
                    instruction_index_string=ep.get("instruction_index_string"),
                    extras=extras,
                )
            )

    def __len__(self):
        return len(self.episodes)
