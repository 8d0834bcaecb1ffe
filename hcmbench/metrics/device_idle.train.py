"""The share of the traced window in which the card (rank 0's) runs no
kernel, copy or fill, in %."""

from hcmbench.readers import device_idle


def read(record):
    return device_idle(record) if "window_len" in record else None
