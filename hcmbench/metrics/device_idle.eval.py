"""The share of the traced replays' window in which the card runs no
kernel, copy or fill, in %."""

from hcmbench.readers import device_idle


def read(record):
    return device_idle(record) if "graph_ticks" in record else None
