"""The traced run: ``torch.profiler`` over a few steps, and the reduction of
its trace to what the per-layer metrics read.

A traced run profiles twice: the card alone (its busy share, kernels and
window, with the host untraced and so unhindered), then host and card (the
profiler ranges' device time and what the host did while the card idled).
Each profile is exported as a Chrome trace into a fresh directory under the
process's temporary directory, read back, and deleted.  From it:

* device operations: every kernel, copy and fill on the card, with its name,
  start and length;
* busy seconds: the union of those intervals; the traced window is the
  host's wall time around the profiled steps;
* a profiler range's device time: the kernels whose launch (matched by the
  launch's correlation id) lies inside one of the range's host intervals on
  the same thread; a CUDA graph's kernels belong to its replay's launch;
* idle gaps: the intervals of the window where the card runs nothing, each
  named by the innermost host range or operator running at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op")


@dataclass
class Trace:
    window_s: float
    ops: List[Tuple[str, float, float, int]]  # (name, start us, duration us, correlation)
    launches: Dict[int, Tuple[int, float]]  # correlation -> (thread, time us)
    ranges: Dict[str, List[Tuple[int, float, float]]]  # name -> [(thread, start, end)] us
    host: List[Tuple[int, float, float, str]] = field(default_factory=list)  # (tid, start, end, name)

    # -- reductions ---------------------------------------------------------------------

    def kernels(self, *patterns) -> List[Tuple[str, float, float, int]]:
        """Device operations whose name contains one of ``patterns``."""
        return [op for op in self.ops if any(p in op[0] for p in patterns)]

    def busy_s(self) -> float:
        total, end = 0.0, -1e30
        for _, start, dur, _ in sorted(self.ops, key=lambda op: op[1]):
            stop = start + dur
            if stop > end:
                total += stop - max(start, end)
                end = stop
        return total / 1e6

    def range_device_s(self, *names) -> float:
        """Device seconds of the kernels launched inside any range ``names``."""
        spans = defaultdict(list)
        for name in names:
            for tid, start, end in self.ranges.get(name, ()):
                spans[tid].append((start, end))
        for tid in spans:
            spans[tid].sort()
        total = 0.0
        for _, _, dur, corr in self.ops:
            launch = self.launches.get(corr)
            if launch is None or launch[0] not in spans:
                continue
            tid, at = launch
            ivs = spans[tid]
            i = bisect.bisect_right(ivs, (at, float("inf"))) - 1
            # ranges of one name may nest; look back over every start before the launch
            while i >= 0:
                if ivs[i][0] <= at <= ivs[i][1]:
                    total += dur
                    break
                i -= 1
        return total / 1e6

    def top_ops(self, n=10) -> List[list]:
        by_name = defaultdict(float)
        for name, _, dur, _ in self.ops:
            by_name[name[:160]] += dur / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10) -> List[list]:
        """The idle time between device operations, summed by the innermost
        host range or operator running at each gap's middle; the n largest."""
        ops = sorted(self.ops, key=lambda op: op[1])
        by_label = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        end = None
        for _, start, dur, _ in ops:
            if end is not None and start > end:
                mid = (start + end) / 2
                label = "no host range"
                best = None
                i = bisect.bisect_right(starts, mid)
                for tid, s, e, name in host[max(0, i - 400):i]:
                    if s <= mid <= e and (best is None or s >= best[0]):
                        best = (s, name)
                if best is not None:
                    label = best[1]
                by_label[label[:160]] += (start - end) / 1e6
            end = max(end or start + dur, start + dur)
        return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:n]]


def parse(path: str, window_s: float) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, launches, ranges, host = [], {}, defaultdict(list), []
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X" or cat is None:
            continue
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append((ev["name"], float(ev["ts"]), float(ev.get("dur", 0.0)),
                        int(args.get("correlation", -1))))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[int(args["correlation"])] = (ev["tid"], float(ev["ts"]))
        elif cat in HOST_CATS:
            start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            if cat == "user_annotation":
                ranges[ev["name"]].append((ev["tid"], start, start + dur))
            host.append((ev["tid"], start, start + dur, ev["name"]))
    return Trace(window_s, ops, launches, dict(ranges), host)


def profile(step, steps: int, host: bool, warmup: int = 2) -> Trace:
    """Run ``step`` ``warmup`` times under a warming profiler, then ``steps``
    times traced, and return the reduced trace; the window is the host's
    wall time around the traced steps, the last ending in a synchronisation
    of the card.  With ``host`` the host's operators and ranges are traced
    too, which costs the host some microseconds an operator and so
    stretches the window; without, only the card's activity is."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    plan = schedule(wait=0, warmup=warmup, active=steps, repeat=1)
    with torch_profile(activities=activities, schedule=plan) as prof:
        for _ in range(warmup):
            step()
            prof.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step()
            if i == steps - 1:
                torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
            prof.step()
    tmp = tempfile.mkdtemp(prefix="hcmbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return parse(path, window_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile_within(run, steps: int, host: bool, warmup: int = 1) -> Trace:
    """As :func:`profile`, where the steps happen inside ``run(step)``,
    which calls ``step()`` after each of them (a CUDA graph's replays inside
    a rollout): the profiler starts after the ``warmup``-th and stops after
    ``steps`` more, with nothing of its own between them; ``run`` is called
    until it has."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    prof = torch_profile(activities=activities)
    seen = {"n": 0, "t0": None, "window": None}

    def step():
        n = seen["n"] = seen["n"] + 1
        if n == warmup:
            torch.cuda.synchronize()
            prof.start()
            seen["t0"] = time.perf_counter()
        elif n == warmup + steps:
            torch.cuda.synchronize()
            seen["window"] = time.perf_counter() - seen["t0"]
            prof.stop()

    while seen["window"] is None:
        run(step)
    tmp = tempfile.mkdtemp(prefix="hcmbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return parse(path, seen["window"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
