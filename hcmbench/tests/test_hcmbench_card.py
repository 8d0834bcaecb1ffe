"""On a CUDA card only (marked ``card``; each skips without one): a short
run of every one-card cell at its own size comes out correct, and the
control at the cell's own size fails one of its limits.

    python -m pytest hcmbench/tests -m card
"""

import json
import os
import subprocess
import sys

import pytest

from hcmbench import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _cards():
    import torch

    return torch.cuda.device_count()


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name, card):
    cell = harness.load_cell(name)
    if _cards() < cell.chips:
        pytest.skip(f"needs {cell.chips} cards")
    out = subprocess.run([sys.executable, "hcmbench/run.py", "--workload", name, "--seed",
                          str(2**31 + 101), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=1500, cwd=harness.ROOT,
                         env={**os.environ})
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", [c for c in CELLS if harness.load_cell(c).mix["driver"] == "train"])
def test_control_fails_at_full_size(name, card):
    from hcmbench import calibrate

    cell = harness.load_cell(name)
    out = calibrate.control_readings(cell, [2**31 + 202], "cuda")[2**31 + 202]["control"]
    assert any(out[k] > limit for k, limit in cell.limits.items())
