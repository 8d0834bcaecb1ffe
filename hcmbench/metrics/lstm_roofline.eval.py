"""The tick's LSTM kernels (T = 1, inside the graph) against their roofline,
in % (hcmbench/readers.py)."""

from hcmbench.readers import lstm_roofline


def read(record):
    return lstm_roofline(record) if "graph_ticks" in record else None
