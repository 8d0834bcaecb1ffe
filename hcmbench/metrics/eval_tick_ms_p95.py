"""The 95th percentile, over every graph replay of a traced run's untraced
batches, of the replay's time by the rollout's own CUDA events divided by
its ticks."""

from hcmbench.harness import percentile


def read(record):
    if not record.get("tick_ms") or "graph_ticks" not in record:
        return None
    return percentile(record["tick_ms"], 95)
