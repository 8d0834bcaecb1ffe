"""The 95th percentile of the window's step intervals, each from the return
of the step before it to its own, stamped by CUDA events on the step's
stream (on rank 0 across cards)."""

from hcmbench.harness import percentile


def read(record):
    if "step_ms" not in record or "window_len" not in record:
        return None
    return percentile(record["step_ms"], 95)
