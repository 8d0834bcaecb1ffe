"""Dynamic time warping for nDTW/SDTW metrics (host-side); the port's own
copy of robo_vln_tpu/tasks/dtw.py.

The reference computes nDTW with the `fastdtw` package
(habitat_extensions/measures.py:297,327-334 and the trainers' eval loops).
That package isn't in the image; this module provides:

* :func:`dtw` — exact O(N*M) DTW with euclidean point distance;
* :func:`fastdtw` — the multilevel approximation (Salvador & Chan 2007):
  coarsen by 2, solve recursively, refine within a projected window of
  ``radius``; same signature/semantics as fastdtw.fastdtw for list-of-point
  inputs;
* a native C++ windowed-DTW core (sim/dtw.cc, built by sim/build.py into
  build/sim/) used whenever it builds, with a pure-Python fallback
  (episodes run up to 1000 steps at 30 Hz — the metric is hot in eval).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..utils.logging import logger

_lib = None


def _native():
    global _lib
    if _lib is None:
        try:
            from ..sim.build import load

            lib = load("dtw")
            lib.dtw_window.restype = ctypes.c_double
            lib.dtw_window.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            _lib = lib
        except Exception as e:  # noqa: BLE001 — the Python path computes the same
            logger.warning(f"native DTW unavailable ({e}); using the Python path")
            _lib = False
    return _lib or None


def _as_array(path) -> np.ndarray:
    a = np.asarray(path, np.float64)
    if a.ndim == 1:
        a = a[:, None]
    return a


def _dtw_windowed(x: np.ndarray, y: np.ndarray,
                  window: Optional[List[Tuple[int, int]]]) -> float:
    n, m = len(x), len(y)
    if window is None:
        window = [(i, j) for i in range(n) for j in range(m)]
    lib = _native()
    if lib is not None:
        warr = np.asarray(window, np.int32).reshape(-1)
        return float(
            lib.dtw_window(
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
                y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m,
                x.shape[1],
                warr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                len(window),
            )
        )
    # pure-python fallback
    INF = float("inf")
    D = {(-1, -1): 0.0}
    for i, j in window:
        D[(i, j)] = INF
    for i, j in window:
        dist = float(np.linalg.norm(x[i] - y[j]))
        best = min(
            D.get((i - 1, j), INF), D.get((i, j - 1), INF),
            D.get((i - 1, j - 1), INF),
        )
        if (i, j) == (0, 0):
            best = 0.0
        D[(i, j)] = dist + best
    return D[(n - 1, m - 1)]


def dtw(x, y, dist=None) -> Tuple[float, None]:
    """Exact DTW. Returns (distance, None) — path reconstruction not needed by
    the metrics."""
    x, y = _as_array(x), _as_array(y)
    return _dtw_windowed(x, y, None), None


def _reduce_by_half(x: np.ndarray) -> np.ndarray:
    n = len(x) // 2
    pairs = x[: 2 * n].reshape(n, 2, -1).mean(axis=1)
    if len(x) % 2:
        pairs = np.concatenate([pairs, x[-1:][..., : x.shape[1]]], axis=0)
    return pairs


def _expand_window(path_estimate, n, m, radius):
    window = set()
    for i, j in path_estimate:
        for a in range(-radius, radius + 1):
            for bb in range(-radius, radius + 1):
                window.add((i + a, j + bb))
    expanded = set()
    for i, j in window:
        for (ii, jj) in ((2 * i, 2 * j), (2 * i, 2 * j + 1),
                         (2 * i + 1, 2 * j), (2 * i + 1, 2 * j + 1)):
            if 0 <= ii < n and 0 <= jj < m:
                expanded.add((ii, jj))
    return sorted(expanded)


def _dtw_path(x: np.ndarray, y: np.ndarray, window) -> List[Tuple[int, int]]:
    """DTW with path backtracking (used on coarse levels)."""
    n, m = len(x), len(y)
    INF = float("inf")
    if window is None:
        window = [(i, j) for i in range(n) for j in range(m)]
    D = {}
    for i, j in window:
        dist = float(np.linalg.norm(x[i] - y[j]))
        choices = []
        if (i - 1, j) in D:
            choices.append((D[(i - 1, j)][0], (i - 1, j)))
        if (i, j - 1) in D:
            choices.append((D[(i, j - 1)][0], (i, j - 1)))
        if (i - 1, j - 1) in D:
            choices.append((D[(i - 1, j - 1)][0], (i - 1, j - 1)))
        if (i, j) == (0, 0):
            D[(i, j)] = (dist, None)
        elif choices:
            best, prev = min(choices)
            D[(i, j)] = (dist + best, prev)
    path = []
    node = (n - 1, m - 1)
    while node is not None:
        path.append(node)
        node = D[node][1]
    return list(reversed(path))


def fastdtw(x, y, radius: int = 1, dist=None) -> Tuple[float, None]:
    """Multilevel approximate DTW (fastdtw semantics)."""
    x, y = _as_array(x), _as_array(y)

    def rec(x, y):
        n, m = len(x), len(y)
        min_size = radius + 2
        if n < min_size or m < min_size:
            return _dtw_path(x, y, None)
        path = rec(_reduce_by_half(x), _reduce_by_half(y))
        window = _expand_window(path, n, m, radius)
        return _dtw_path(x, y, window)

    n, m = len(x), len(y)
    min_size = radius + 2
    if n < min_size or m < min_size:
        return _dtw_windowed(x, y, None), None
    coarse_path = rec(_reduce_by_half(x), _reduce_by_half(y))
    window = _expand_window(coarse_path, n, m, radius)
    return _dtw_windowed(x, y, window), None


def ndtw(locations, gt_locations, success_distance: float) -> float:
    """exp(-DTW / (|gt| * d_th)) — measures.py:327-334 / trainer eval
    (robo_vln_trainer.py:1190-1192)."""
    d, _ = fastdtw(locations, gt_locations)
    return float(np.exp(-d / (len(gt_locations) * success_distance)))
