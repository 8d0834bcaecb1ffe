"""The train step's LSTM kernels against their roofline, in % (hcmbench/readers.py)."""

from hcmbench.readers import lstm_roofline


def read(record):
    return lstm_roofline(record) if "window_len" in record else None
