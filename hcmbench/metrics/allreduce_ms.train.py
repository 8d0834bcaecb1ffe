"""Rank 0's device ms a train step under hier_train_step.all_reduce (or
flat_train_step.all_reduce): the NCCL all-reduce of gradients and losses,
which includes rank 0's wait for the slowest rank."""

from hcmbench.readers import range_ms


def read(record):
    if "window_len" not in record or record.get("ranks", 1) < 2:
        return None
    return range_ms(record, "hier_train_step.all_reduce", "flat_train_step.all_reduce")
