#!/usr/bin/env python3
"""Probe what holds the LSTM's backward kernels on one CUDA card.

    python3 scripts/lstm_backward_probe.py [--units 4,8]

Builds csrc/lstm_seq.cu into build/kernels/ and prints, after the card's
name and power limit and each backward instance's registers and spills:

1. Each backward kernel (``partials``, the route, at each number of units a
   block given; ``dg_exchange``) held against the plain backward
   (ops/rnn.lstm_recurrence_backward) at a train step's shape (T=50, B=4,
   H=512) and at ragged ones, with and without the masks' gradient; then
   both kernels in turns on one workspace, each result bitwise equal to
   its first.
2. At T=50, B=4, H=512, with CUDA events (10 reps of 10 calls, each rep
   queued behind a device sleep): the forward kernel and its grid running
   nothing but the h exchange; for each backward kernel, its launch alone,
   its grid running nothing but its exchange, and the whole backward call,
   each also per reverse step.

The last line is one JSON object with every time.  Exits non-zero without
a CUDA card or when a kernel disagrees with the plain backward.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from robo_vln_tpu_torch.ops import _build, fused_lstm  # noqa: E402
from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward  # noqa: E402
from robo_vln_tpu_torch.utils.device import float32_exact  # noqa: E402

SHAPES = ((50, 4, 512), (7, 11, 64), (4, 3, 556), (3, 28, 1024), (1, 8, 512))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--units", default="4,8",
                        help="units a block of the partials kernel at H=512, comma-separated")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("lstm_backward_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(chip_smoke.card_line())
    logs = _build.build_all(["lstm_seq"])
    for kernel, regs, spill in chip_smoke.ptxas_usage(logs.get("lstm_seq", "")):
        if "backward" in kernel:
            print(f"  {kernel}: {regs} registers, {spill} bytes spill stores")
    units_list = [int(u) for u in opts.units.split(",")]
    runs = [("partials", u) for u in units_list] + [("dg_exchange", None)]
    gen = torch.Generator().manual_seed(0)
    out = {"card": chip_smoke.card_line()}

    with float32_exact(torch.float32):
        for T, B, H in SHAPES:
            args = chip_smoke.lstm_inputs(gen, T, B, H, device)
            outs = lstm_recurrence(*args)[0]
            cots = chip_smoke.lstm_cotangents(gen, T, B, H, device)
            for masks_grad in (True, False):
                ref = lstm_recurrence_backward(*args, outs, *cots, masks_grad=masks_grad)
                for kernel, units in runs:
                    if units is not None and H != 512:
                        units = None  # the wrapper's own units past the train step's H
                    with chip_smoke.backward_kernel(kernel, units):
                        got = fused_lstm.lstm_seq_backward_cuda(*args, outs, *cots,
                                                                masks_grad=masks_grad)
                    torch.cuda.synchronize()
                    rel = max((g - r).abs().max().item() / max(r.norm().item(), 1e-30)
                              for g, r in zip(got, ref) if r is not None)
                    print(f"  T={T} B={B} H={H} {kernel} units {units or 'default'}, masks "
                          f"gradient {masks_grad}: largest error {rel:.3e} of its gradient's "
                          f"norm (tolerance {chip_smoke.LSTM_BACKWARD_TOL})")
                    if not rel <= chip_smoke.LSTM_BACKWARD_TOL:
                        raise SystemExit(f"{kernel} disagrees with the plain backward")

        # both kernels in turns on one workspace: the tags and the epoch
        T, B, H = 50, 4, 512
        args = chip_smoke.lstm_inputs(gen, T, B, H, device)
        outs = lstm_recurrence(*args)[0]
        cots = chip_smoke.lstm_cotangents(gen, T, B, H, device)
        fused_lstm._workspaces.clear()
        first = {}
        for rep in range(3):
            for kernel, units in runs:
                with chip_smoke.backward_kernel(kernel, units):
                    got = fused_lstm.lstm_seq_backward_cuda(*args, outs, *cots)
                    fused_lstm.lstm_seq_cuda(*args)
                torch.cuda.synchronize()
                key = (kernel, units)
                first.setdefault(key, got)
                if not all(torch.equal(a, b) for a, b in zip(got, first[key])):
                    raise SystemExit(f"{kernel} gave another result in turn {rep}")
        print("  both kernels in turns on one workspace, three times: bitwise equal")

        time_ms, report = chip_smoke.time_ms, chip_smoke.report_times
        fwd = report("forward kernel", time_ms(lambda: fused_lstm.lstm_seq_cuda(*args)))
        fwd_x = report("forward, the h exchange alone",
                       time_ms(lambda: fused_lstm.exchange_floor_cuda(T, B, H, device)))
        out.update(forward_ms=fwd, forward_exchange_ms=fwd_x,
                   forward_step_us=fwd / T * 1e3, forward_exchange_step_us=fwd_x / (T - 1) * 1e3)
        w = args[4]
        h_tilde = torch.cat([args[2][None], outs[:-1]]) * args[1][..., None]
        gates = args[0] + h_tilde @ w
        for kernel, units in runs:
            tag = f"{kernel}" + (f"_u{units}" if units else "")
            with chip_smoke.backward_kernel(kernel, units):
                launch = report(f"{tag}: the launch alone", time_ms(
                    lambda: fused_lstm._backward_launch(gates, args[1], args[3], w, *cots,
                                                        False)))
                floor = report(f"{tag}: its exchange alone", time_ms(
                    lambda: fused_lstm.backward_exchange_floor_cuda(T, B, H, device)))
                whole = report(f"{tag}: the whole call", time_ms(
                    lambda: fused_lstm.lstm_seq_backward_cuda(*args, outs, *cots,
                                                              masks_grad=False)))
            print(f"  {tag} per reverse step: launch {launch / T * 1e3:.3f} us, exchange "
                  f"{floor / T * 1e3:.3f} us")
            out.update({f"{tag}_launch_ms": launch, f"{tag}_exchange_ms": floor,
                        f"{tag}_ms": whole, f"{tag}_step_us": launch / T * 1e3,
                        f"{tag}_exchange_step_us": floor / T * 1e3})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
