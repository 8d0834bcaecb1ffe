"""Task measures (host-side metrics updated per sim step); the port's own
copy of robo_vln_tpu/tasks/measures.py.  ``TOP_DOWN_MAP`` (:class:`TopDownMap`)
draws with OpenCV, imported when the measure runs, as in the JAX package;
``get_config`` refuses the measure where cv2 is missing.

Equivalents of the reference's habitat_extensions/measures.py plus the two
habitat built-ins the task config uses (DistanceToGoal, SPL).  Each measure
follows the habitat Measure contract: reset_metric(episode) on episode start,
update_metric(episode) per step, .metric readable anytime.

Sim access is abstracted to two calls: `sim.get_agent_position() -> (3,)` and
`sim.geodesic_distance(a, b) -> float` — provided by any env backend (habitat
adapter, kinematic C++ sim, replay env).
"""

from __future__ import annotations

import gzip
import json
from typing import Dict, List

import numpy as np

from ..utils.registry import lookup, register
from . import dtw as dtw_lib


def _euclidean(a, b) -> float:
    return float(np.linalg.norm(np.asarray(b) - np.asarray(a)))


class Measure:
    uuid: str = ""

    def __init__(self, sim, config):
        self._sim = sim
        self._config = config
        self._metric = None

    def reset_metric(self, episode) -> None:
        raise NotImplementedError

    def update_metric(self, episode, **kwargs) -> None:
        raise NotImplementedError

    @property
    def metric(self):
        return self._metric


def register_measure(name: str):
    return register("measure", name)


def get_measure(name: str):
    return lookup("measure", name)


@register_measure("PATH_LENGTH")
class PathLength(Measure):
    """Cumulative euclidean path length (measures.py:14-59)."""

    uuid = "path_length"

    def reset_metric(self, episode):
        self._previous = self._sim.get_agent_position()
        self._metric = 0.0

    def update_metric(self, episode, **kwargs):
        cur = self._sim.get_agent_position()
        self._metric += _euclidean(cur, self._previous)
        self._previous = cur


@register_measure("DISTANCE_TO_GOAL")
class DistanceToGoal(Measure):
    uuid = "distance_to_goal"

    def reset_metric(self, episode):
        self._metric = self._sim.geodesic_distance(
            self._sim.get_agent_position(), episode.goals[0].position
        )

    def update_metric(self, episode, **kwargs):
        self._metric = self._sim.geodesic_distance(
            self._sim.get_agent_position(), episode.goals[0].position
        )


@register_measure("NAVIGATION_ERROR")
class NavigationError(Measure):
    """Geodesic distance to goal, every step (measures.py:62-90)."""

    uuid = "navigation_error"

    def reset_metric(self, episode):
        self._metric = None

    def update_metric(self, episode, **kwargs):
        self._metric = self._sim.geodesic_distance(
            self._sim.get_agent_position(), episode.goals[0].position
        )


@register_measure("ORACLE_NAVIGATION_ERROR")
class OracleNavigationError(Measure):
    """min over the path of the geodesic distance (measures.py:93-122)."""

    uuid = "oracle_navigation_error"

    def reset_metric(self, episode):
        self._metric = float("inf")

    def update_metric(self, episode, **kwargs):
        d = self._sim.geodesic_distance(
            self._sim.get_agent_position(), episode.goals[0].position
        )
        self._metric = min(self._metric, d)


@register_measure("SUCCESS")
class Success(Measure):
    """I(distance < SUCCESS_DISTANCE) — the stop-called check is commented out
    in the reference (measures.py:149-159), preserved as-is."""

    uuid = "success"

    def reset_metric(self, episode):
        self._metric = 0

    def update_metric(self, episode, **kwargs):
        d = self._sim.geodesic_distance(
            self._sim.get_agent_position(), episode.goals[0].position
        )
        self._metric = float(d < self._config.SUCCESS_DISTANCE)


@register_measure("SPL")
class SPL(Measure):
    """Success weighted by path length (habitat built-in used by the task
    yaml); success here uses the same distance-only criterion as SUCCESS."""

    uuid = "spl"

    def reset_metric(self, episode):
        self._previous = self._sim.get_agent_position()
        self._start_distance = episode.info.get(
            "geodesic_distance",
            self._sim.geodesic_distance(self._previous, episode.goals[0].position),
        )
        self._agent_distance = 0.0
        self._metric = 0.0

    def update_metric(self, episode, **kwargs):
        cur = self._sim.get_agent_position()
        self._agent_distance += _euclidean(cur, self._previous)
        self._previous = cur
        d = self._sim.geodesic_distance(cur, episode.goals[0].position)
        success = float(d < self._config.SUCCESS_DISTANCE)
        self._metric = success * (
            self._start_distance
            / max(self._start_distance, self._agent_distance, 1e-8)
        )


@register_measure("ORACLE_SPL")
class OracleSPL(Measure):
    """max SPL over all points of the path (measures.py:202-253): latches the
    first in-radius point."""

    uuid = "oracle_spl"

    def reset_metric(self, episode):
        self._previous = self._sim.get_agent_position()
        self._start_distance = episode.info.get(
            "geodesic_distance",
            self._sim.geodesic_distance(self._previous, episode.goals[0].position),
        )
        self._agent_distance = 0.0
        self._success = 0
        self._metric = 0.0

    def update_metric(self, episode, **kwargs):
        if self._success:
            return
        cur = self._sim.get_agent_position()
        self._agent_distance += _euclidean(cur, self._previous)
        self._previous = cur
        d = self._sim.geodesic_distance(cur, episode.goals[0].position)
        if d < self._config.SUCCESS_DISTANCE:
            self._success = 1
            self._metric = self._start_distance / max(
                self._start_distance, self._agent_distance, 1e-8
            )


@register_measure("STEPS_TAKEN")
class StepsTaken(Measure):
    uuid = "steps_taken"

    def reset_metric(self, episode):
        self._metric = 0

    def update_metric(self, episode, **kwargs):
        self._metric += 1


class _DTWBase(Measure):
    def __init__(self, sim, config):
        super().__init__(sim, config)
        self.locations: List = []
        self.gt_locations: List = []
        gt_path = config.GT_PATH.format(split=config.SPLIT)
        try:
            with gzip.open(gt_path, "rt") as f:
                self.gt_json = json.load(f)
        except FileNotFoundError:
            self.gt_json = {}

    def reset_metric(self, episode):
        self.locations = []
        self.gt_locations = self.gt_json.get(
            str(episode.episode_id), {}
        ).get("locations", [])
        if not self.gt_locations:
            # fall back to the episode's reference path (self-contained eval)
            self.gt_locations = list(episode.reference_path) + [
                episode.goals[0].position
            ]
        self._metric = None

    def _append_location(self) -> bool:
        cur = list(self._sim.get_agent_position())
        if self.locations and cur == self.locations[-1]:
            return False
        self.locations.append(cur)
        return True

    def _ndtw(self) -> float:
        d, _ = dtw_lib.fastdtw(self.locations, self.gt_locations)
        return float(
            np.exp(-d / (len(self.gt_locations) * self._config.SUCCESS_DISTANCE))
        )


@register_measure("NDTW")
class NDTW(_DTWBase):
    """Normalized DTW (measures.py:282-334)."""

    uuid = "ndtw"

    def update_metric(self, episode, **kwargs):
        if not self._append_location() and self._metric is not None:
            return
        self._metric = self._ndtw()


@register_measure("SDTW")
class SDTW(_DTWBase):
    """Success-weighted nDTW (measures.py:337-397); success uses is_stop_called
    AND distance like the reference."""

    uuid = "sdtw"

    def update_metric(self, episode, is_stop_called: bool = False, **kwargs):
        self._append_location()
        nd = self._ndtw()
        d = self._sim.geodesic_distance(
            self._sim.get_agent_position(), episode.goals[0].position
        )
        success = 1 if (is_stop_called and d < self._config.SUCCESS_DISTANCE) else 0
        self._metric = success * nd


def build_measures(names: List[str], sim, task_config) -> Dict[str, Measure]:
    """Instantiate the task's MEASUREMENTS list; per-measure config nodes come
    from the task tree by name (habitat convention)."""
    out = {}
    for name in names:
        cfg = task_config.get(name, task_config)
        m = get_measure(name)(sim, cfg)
        out[m.uuid] = m
    return out


@register_measure("TOP_DOWN_MAP")
class TopDownMap(Measure):
    """Top-down trajectory map (reference habitat TopDownMap, configured at
    habitat_extensions/config/default.py:97-117; commented out of the default
    MEASUREMENTS list at robo_vln_task.yaml:36 — same here).

    The habitat original rasterizes the navmesh; the kinematic/replay backends
    have none, so the map canvas is the episode's bounding box (reference path
    + start + goals + MAP_PADDING meters) and the same info structure is
    produced for the viz tile: {"map": HxWx3 uint8 RGB, "agent_map_coord":
    (row, col), "agent_angle": heading}.  Drawn per DRAW_* flags: shortest
    (reference) path in green, agent track in blue, source and goal dots.

    ``agent_angle`` is always 0.0, as the JAX package computes it: its
    heading lookup imports ``heading_from_quaternion`` from a module that
    does not define it, and its fallback returns 0.0, so the tile's heading
    tick always points up.  Kept, so that the frames match.
    """

    uuid = "top_down_map"

    _BG = (255, 255, 255)
    _BORDER = (60, 60, 60)
    _SHORTEST = (0, 200, 0)
    _TRACK = (30, 60, 220)
    _SOURCE = (50, 50, 255)
    _GOAL = (220, 40, 40)

    def _world_to_px(self, p):
        x, z = float(p[0]), float(p[2])
        r = int(round((z - self._zmin) / self._scale))
        c = int(round((x - self._xmin) / self._scale))
        h, w = self._map.shape[:2]
        return min(max(r, 0), h - 1), min(max(c, 0), w - 1)

    def _info(self, coord):
        return {"map": self._map, "agent_map_coord": coord, "agent_angle": 0.0}

    def reset_metric(self, episode):
        import cv2

        pad = float(self._config.get("MAP_PADDING", 3))
        res = int(self._config.get("MAP_RESOLUTION", 1250))
        pts = [list(episode.start_position)]
        pts += [list(p) for p in episode.reference_path]
        pts += [list(g.position) for g in episode.goals]
        xs = [p[0] for p in pts]
        zs = [p[2] for p in pts]
        self._xmin, self._zmin = min(xs) - pad, min(zs) - pad
        xmax, zmax = max(xs) + pad, max(zs) + pad
        span = max(xmax - self._xmin, zmax - self._zmin, 1e-3)
        self._scale = span / res  # meters per pixel
        h = max(int(round((zmax - self._zmin) / self._scale)), 2)
        w = max(int(round((xmax - self._xmin) / self._scale)), 2)
        self._map = np.full((h, w, 3), self._BG, np.uint8)

        if self._config.get("DRAW_BORDER", True):
            cv2.rectangle(self._map, (0, 0), (w - 1, h - 1), self._BORDER, 1)
        if self._config.get("DRAW_SHORTEST_PATH", True):
            path = [self._world_to_px(p) for p in episode.reference_path]
            for a, b in zip(path, path[1:]):
                cv2.line(self._map, (a[1], a[0]), (b[1], b[0]),
                         self._SHORTEST, max(res // 300, 1))
        dot = max(res // 150, 2)
        if self._config.get("DRAW_SOURCE", True):
            r, c = self._world_to_px(episode.start_position)
            cv2.circle(self._map, (c, r), dot, self._SOURCE, -1)
        if self._config.get("DRAW_GOAL_POSITIONS", True):
            for g in episode.goals:
                r, c = self._world_to_px(g.position)
                cv2.circle(self._map, (c, r), dot, self._GOAL, -1)

        self._prev_px = self._world_to_px(self._sim.get_agent_position())
        self._metric = self._info(self._prev_px)

    def update_metric(self, episode, **kwargs):
        import cv2

        cur = self._world_to_px(self._sim.get_agent_position())
        cv2.line(
            self._map, (self._prev_px[1], self._prev_px[0]), (cur[1], cur[0]),
            self._TRACK, max(self._map.shape[0] // 300, 1),
        )
        self._prev_px = cur
        self._metric = self._info(cur)
