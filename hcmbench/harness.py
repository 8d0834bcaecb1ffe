"""What every run of the benchmark shares: finding a cell's files by name,
the card's description, the guard against JAX in the process, and the
result line.

The card (``CARD``) is the one seam between a run and the device: every
synchronisation, time stamp, memory reading and the card's description go
through it.  A run knows only the CUDA card; the benchmark's tests rehearse
on the CPU by putting ``hcmbench/tests/tiny.py``'s stand-in in its place.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) joins by name:
``configs/<config>.json`` (the configuration), ``mixes/<traffic>.json`` (the
traffic; its ``driver`` names ``drivers/<driver>.py``), ``limits/<cell>.json``
(the limits of the comparison that decides ``correct``) and, for each metric
of the cell, ``metrics/<metric>.py``, whose ``read(record)`` returns the
metric's value from the run's record, or None when the record holds nothing
for it.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "robo_vln_tpu")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read; raises
    KeyError for a name the file does not hold and FileNotFoundError for a
    file that is missing."""
    bench = _json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {bench_path.name}")
    return Cell(
        name=name, config_name=entry["config"], traffic=entry["traffic"], chips=entry["chips"],
        config=_json(BENCH_DIR / "configs" / f"{entry['config']}.json"),
        mix=_json(BENCH_DIR / "mixes" / f"{entry['traffic']}.json"),
        limits=_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def driver(cell: Cell):
    return importlib.import_module(f"hcmbench.drivers.{cell.mix['driver']}")


def family(cell: Cell):
    return importlib.import_module(f"hcmbench.families.{cell.config['family']}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hcmbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], record) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds a value."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# -- the card -----------------------------------------------------------------------------

def power_limits() -> List[str]:
    """Each card's power limit as nvidia-smi reads it (none where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def require_cards(n: int) -> None:
    """Exit with code 3 (and no result) unless ``n`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"hcmbench: this cell needs {n} CUDA card(s); found {found}", file=sys.stderr)
        sys.exit(3)


class Card:
    """The CUDA card as a run measures it."""

    device = "cuda"
    traces = True  # the profiler reads this card's kernels

    def sync(self, device=None) -> None:
        import torch

        torch.cuda.synchronize(device)

    def stamp(self):
        """A mark on the current stream; :meth:`elapsed_ms` between two."""
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b)

    def peak_bytes(self, device=None) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(device))

    def release(self) -> None:
        """Free what the program's state held before the reference runs."""
        import torch

        gc.collect()
        torch.cuda.empty_cache()

    def describe(self, count: int, peak_bytes: int) -> dict:
        import torch

        limits = power_limits()
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(peak_bytes),
                "power_limit": limits[0] if limits else "not read"}


CARD = Card()


# -- the guard ----------------------------------------------------------------------------

def forbidden_loaded() -> List[str]:
    """Modules in this process whose top-level name (before the first dot)
    is jax, jaxlib, flax or the JAX package, compared whole.  A driver that
    runs the program in processes of its own returns theirs under the key
    ``forbidden`` of its output; the harness reads both."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


# -- statistics ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between the closest ranks."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# -- the result ---------------------------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: Dict[str, dict], breakdown: Optional[dict] = None) -> str:
    """The last line of standard output; ``checks`` (each number compared
    beside its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: Dict[str, dict]) -> str:
    return "\n".join(f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                     for k, v in checks.items())
