"""On several cards: the 95th percentile of a traced run's window of steps,
run before the profile, each interval from the return of the step before it
to its own, stamped by CUDA events on rank 0's step stream.  The same
quantity as train_step_ms_p95, whose tail across ranks spreads too widely
from run to run to hold a bound."""

from hcmbench.harness import percentile


def read(record):
    if not record.get("window_step_ms") or record.get("ranks", 1) < 2:
        return None
    return percentile(record["window_step_ms"], 95)
