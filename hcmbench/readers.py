"""Reductions that several metric files share: a kernel's share of its
roofline, the whole step's share of the card's peak, the device's idle
share, and a profiler range's device time a step.  Each returns None when
the traced run holds nothing for it."""

from __future__ import annotations

from .flops import (BF16_TC_FLOP_PER_S, F32_FLOP_PER_S, attn_bound_ms, least_ms, lstm_bound_ms,
                    lstm_backward_bound_ms)

LSTM_KERNELS = ("lstm_seq",)
LSTM_BACKWARD_KERNELS = ("lstm_seq_backward",)
ATTN_KERNELS = ("cross_modal_attn",)


def _trace(record):
    return record.get("trace")


def lstm_roofline(record):
    """The least time of the traced steps' LSTM calls (the forward kernel's
    bound a forward call, the backward kernel's own share a backward call)
    over the device time of the kernels named lstm_seq, in %."""
    tr = _trace(record)
    if tr is None:
        return None
    device_s = sum(op[2] for op in tr.kernels(*LSTM_KERNELS)) / 1e6
    calls = record["kernel_calls"]
    if device_s <= 0 or not calls["lstm_forward"]:
        return None
    least = sum(least_ms(lstm_bound_ms(*c)) for c in calls["lstm_forward"])
    least += sum(least_ms(lstm_backward_bound_ms(*c)[1]) for c in calls["lstm_backward"])
    return 100.0 * least * record["trace_steps"] / 1e3 / device_s


def attn_roofline(record):
    """The least time of the traced steps' attention calls (each at its N,
    Lq, S, heads, d and itemsize; bf16 on the tensor cores, float32 on the
    CUDA cores) over the device time of the kernels named
    cross_modal_attn, in %."""
    tr = _trace(record)
    if tr is None or not record["kernel_calls"]["attention"]:
        return None
    device_s = sum(op[2] for op in tr.kernels(*ATTN_KERNELS)) / 1e6
    if device_s <= 0:
        return None
    least = sum(least_ms(attn_bound_ms(n, lq, s, h, d, item,
                                       BF16_TC_FLOP_PER_S if item == 2 else F32_FLOP_PER_S))
                for n, lq, s, h, d, item in record["kernel_calls"]["attention"])
    return 100.0 * least * record["trace_steps"] / 1e3 / device_s


def mfu(record):
    """The FLOPs of ``trace_steps`` steps (counted over the reference) over
    the untraced window that ran them, at one card's bf16 tensor-core peak,
    in %."""
    if "untraced_window_s" not in record or "flops_per_step" not in record:
        return None
    return (100.0 * record["flops_per_step"] * record["trace_steps"]
            / (record["untraced_window_s"] * BF16_TC_FLOP_PER_S))


def device_idle(record):
    tr = _trace(record)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def range_ms(record, *names):
    """Device ms a step of the kernels launched inside the ranges ``names``
    (from the profile of host and card)."""
    tr = record.get("host_trace")
    if tr is None:
        return None
    seconds = tr.range_device_s(*names)
    if seconds <= 0:
        return None
    return seconds * 1e3 / record["trace_steps"]
