"""The train step's cross-modal attention kernels against their roofline,
in % (hcmbench/readers.py)."""

from hcmbench.readers import attn_roofline


def read(record):
    return attn_roofline(record) if "window_len" in record else None
