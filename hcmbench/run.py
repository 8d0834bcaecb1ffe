"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 hcmbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell's name is looked up in
``BENCHMARK.json``; its configuration, traffic mix, driver, limits and
metrics are files under ``hcmbench/`` found by name (hcmbench/harness.py).
The run loads, warms up, measures for ``--seconds`` (``--trace 0``: the
cell's end-to-end metrics) or traces a few steps (``--trace 1``: its
per-layer metrics), checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output; the numbers
compared, each beside its limit, end its standard error too.

Without as many CUDA cards as the cell asks for it exits with code 3, and
with JAX or the JAX package loaded once the window has closed, in this
process or in any rank process it spawned, it exits with code 4; neither
prints a result.
"""

import time

T0 = time.time()  # set-up runs from here to the first timed step

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a library the port uses must not load JAX by itself (transformers reads these)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# every kernel cache at a fixed path inside the checkout: only a cell's first run builds
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))


def execute(cell, t0):
    """The cell's run: (result line, checks text, the forbidden modules
    loaded in this process or in any process of the driver's), or raises."""
    from hcmbench import harness

    drv = harness.driver(cell)
    out = drv.run(cell, t0)
    table, ok = drv.checks(cell, out)
    record = out["record"]
    if cell.trace:
        metrics = harness.read_metrics(cell.per_layer, record)
    else:
        metrics = harness.read_metrics(cell.end_to_end, record)
    device = harness.CARD.describe(cell.chips, out["peak"])
    breakdown = None
    if "trace" in record:
        tr = record["trace"]
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        gaps = record.get("host_trace", tr).idle_gaps()
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": gaps}
    if "reference_s" in out:
        print(f"hcmbench: the reference took {out['reference_s']:.1f} s", file=sys.stderr)
    line = harness.result_line(ok and out["failed"] == 0, out["attempted"], out["failed"],
                               metrics, device, table, breakdown)
    found = sorted(set(harness.forbidden_loaded()) | set(out.get("forbidden", ())))
    return line, harness.checks_text(table), found


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from hcmbench import harness

    cell = harness.load_cell(args.workload)
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, bool(args.trace)
    harness.require_cards(cell.chips)
    line, text, found = execute(cell, T0)
    if found:
        print("hcmbench: JAX or the JAX package is loaded in the run: " + ", ".join(found),
              file=sys.stderr)
        return 4
    print(text, file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
