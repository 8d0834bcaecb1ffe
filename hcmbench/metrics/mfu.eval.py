"""The whole tick's FLOPs over one card's bf16 peak, in %: a tick of the whole
batch (every row stepped, live or not; counted over the reference) times
the ticks the graph replays ran, over the untraced batches' wall time times
989 TFLOP/s."""

from hcmbench.flops import BF16_TC_FLOP_PER_S


def read(record):
    if "graph_ticks" not in record or "untraced_window_s" not in record:
        return None
    ticks = record["replays"] * record["graph_ticks"]
    return 100.0 * record["flops_per_tick"] * ticks / (record["untraced_window_s"]
                                                       * BF16_TC_FLOP_PER_S)
