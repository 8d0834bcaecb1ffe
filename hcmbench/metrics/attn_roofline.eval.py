"""The tick's attention kernels (inside the graph) against their roofline, in
% (hcmbench/readers.py)."""

from hcmbench.readers import attn_roofline


def read(record):
    return attn_roofline(record) if "graph_ticks" in record else None
