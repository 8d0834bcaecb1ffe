"""The whole train step's FLOPs over one card's bf16 peak, in %: the FLOPs of
a rank's step counted over the reference (hcmbench/flops.py) times the
traced steps, over the untraced window that ran as many steps just before
the trace, times 989 TFLOP/s."""

from hcmbench.readers import mfu


def read(record):
    return mfu(record) if "window_len" in record else None
