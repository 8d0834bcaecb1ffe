#!/usr/bin/env python3
"""Drive the PyTorch port (robo_vln_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, one or more lines each; any failure ends the run with a non-zero
exit code and no result line:

1. Device: CUDA must be present; prints nvidia-smi's name and power limit.
2. Build: compiles every CUDA kernel of the port from csrc/ for sm_90a, one
   nvcc per source, all in parallel, into build/kernels/; prints each
   kernel instance's registers and spills, and fails if an instance of the
   float32 tensor-core attention kernel spills.
3. Kernels against their plain versions, float32 with TF32 off (in a scope
   around this phase only), at the shapes of the serving path: the LSTM
   kernel (also at every H range of its template and at batches beyond one
   launch; timed at the tick's
   shape, and as its grid running nothing but the step-to-step exchange of
   h, the floor under a step) and the cross-modal attention
   kernel in its three routes: float32 on the tensor cores (3xTF32, the
   route of every float32 call at these shapes), float32 on the CUDA cores
   (the route of float32 shapes the first does not take) and
   bfloat16 (the serving dtype), each held at the same shapes and at ragged
   ones, where the route each shape takes is checked too.  Prints the
   largest error against the stated tolerance, and every rep's time of the
   kernel, the plain version and one PyTorch library call computing the
   same function, each rep's calls queued on the device behind a sleep so
   that a call shorter than its host cost is timed on the device.  Attention
   is timed with its inputs rotated over several sets, so that no call
   finds them in the L2 cache; at the tick's shape the bfloat16 wrapper is
   also timed unqueued, at the host's dispatch rate.  Phase 3c: shapes
   past the kernels' former ranges (bfloat16 attention at S=144, the depth
   tokens of a 384 px frame, and S=300 in key blocks; float32 attention at
   S=500, K and V read in place; the LSTM at H=556, a ragged grid) must
   launch their kernel once and match the plain version; S=144 is timed
   at the window's size; shapes no kernel takes (an unaligned bfloat16
   call, the LSTM at H=1028) must raise before any launch.
4. Serving path at full published width (BERT-base, TV-ResNet50 at 224 px,
   DDPPO GN-ResNet50 at 256 px, VisualLingAttn d_model 256 / 4 heads, LSTM(512)),
   random weights from seed 0, bfloat16 compute: three teacher-forced windows
   (B=4, T=50, 200 instruction tokens), then 10 closed-loop ticks at B=8 with
   the BERT embedding cached.  The launch counts are zeroed just before and
   read just after; every output must be finite.  Then the float32 agent's
   window is timed (it must launch the float32 tensor-core attention only)
   and compared with the same agent whose kernels are swapped for their
   plain versions, with torch's global TF32 flags at their defaults.  With
   --profile, torch.profiler traces one window and five ticks first and
   prints the device's busy share and top kernels.
5. Train path: the hierarchical train step (training/steps.py) at the same
   width in bfloat16, random weights from seed 0, on the bench's batch
   (B=4, T=50, 200 tokens; AdamW with weight decay 1e-5 on the high level,
   Adam without on the low level, lr 1e-4): five steps, each timed with
   CUDA events and the host clock, each launching each kernel exactly twice;
   every loss finite, the frozen parameters bitwise unchanged, every
   trainable one given a gradient and moved (but the progress monitors,
   which nothing calls: no gradient, unchanged); the peak memory.  With
   --profile, one step is
   traced, split into forward, backward (and its LSTM and attention
   replays) and optimizer.  Then one float32 step, against the same step
   with both kernels swapped for their plain versions, from the same
   weights and batch (lr 0, so the weights stay): losses within 1e-4
   relative, each trainable leaf's gradient within 1e-3 of its norm.
6. Trainer path: ``python -m robo_vln_tpu_torch.run``'s ``run_exp``, twice,
   at the same width in bfloat16 (config from options, no yaml: B=4,
   tbptt 50, one bucket of 100, EPOCHS 2, one epoch a run, RESUME, synced
   trunks), over synthetic buffers the port's writer puts in a temporary
   directory under build/ (8 train episodes of 60-100 steps in the msgpack
   format, 4 eval episodes in the flat format, about 270 MB; removed at the
   end, with the checkpoints).  Run 1 trains epoch 0 (4 steps), validates
   (2 windows) and writes ``ckpt.2``; run 2 resumes from it and writes
   ``ckpt.3`` with 8 train steps.  Checked: the trunks shared, each train
   step and val window launching each kernel exactly twice, every logged
   loss finite, the frozen parameters bitwise unchanged, ``ckpt.2`` loaded
   into a fresh trainer bitwise equal to the first trainer's parameters,
   Adam state and counters, run 2 starting at step 4.  Printed: each step's
   host time (a wrapper around ``trainer.train_step``, set from outside the
   trainer) beside phase 5's bare step, the gaps between steps, the
   epochs, the validation, checkpoint save and load times and size, peak
   memory.  With --profile, run 2 is traced.
7. One JSON line {"kernels": [...]} (``launches``: the serving path's,
   ``train_launches``: the train path's, ``trainer_launches``: the trainer
   path's), then the card's name and power limit, then the last line
   {"ok": true, "device": {...}}.
"""

import contextlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32
# FLOP/s outside the tensor cores (the LSTM, and the float32 attention's
# bound, kept so that its rows stay comparable), and dense bf16 and TF32
# FLOP/s of the tensor cores (the bfloat16 attention route; the float32
# route's three tf32 products, printed beside its bound)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
QUEUE_SLEEP_CYCLES = 10_000_000  # about 5 ms at the H100's clock
L2_ROTATION = 3  # input sets a timed attention call cycles over (>= 44 MB each; L2 50 MB)

LSTM_TOL = 1e-4  # float32; the T sequential steps sum in another order
ATTN_TOL = 1e-4  # float32; another summation order over d_k and S
ATTN_BF16_TOL = 2e-2  # one bfloat16 rounding of outputs of magnitude < 4
WINDOW_TOL = 2e-3  # float32 agent, kernels against plain, through 50 steps
TRAIN_LOSS_RTOL = 1e-4  # float32 train step, kernels against plain, relative
TRAIN_GRAD_TOL = 1e-3  # the same, each leaf's gradient, of that leaf's norm
TRAIN_STEPS = 5
TRAINER_EPISODES = 8  # phase 6: 2 batches of 4, 2 windows of 50 each: 4 steps an epoch
TRAINER_EVAL_EPISODES = 4  # one batch, 2 val windows
# a bias on the keys adds the same q·b to every logit of a query row, which
# the softmax cancels: this leaf's exact gradient is 0
ZERO_GRAD_LEAF = "enc_att.attention.fc_k.bias"


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled):
    """kernel<template args> from a mangled kernel name: the identifier
    ending in _kernel that its length prefix delimits."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        start = m.start() + len(m.group(1))
        word = mangled[start:start + int(m.group(1))]
        if word.endswith("_kernel") and word.isidentifier():
            args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[start + len(word):])
            if args is None:
                return word
            return word + "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
    return mangled


def ptxas_usage(log):
    """(kernel, registers, spill-store bytes) of each kernel instance in an
    ``nvcc -Xptxas -v`` log."""
    usage, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.append((name, int(m.group(1)), spill))
            name, spill = None, 0
    return usage


def time_ms(fn, reps=10, inner=10, warmup=3, queued=True):
    """Per-call ms of fn over ``reps`` CUDA-event windows of ``inner`` calls.
    ``queued``: each window waits on the device behind a sleep of a few ms
    while the host dispatches its calls, so a call shorter than its host
    cost is timed on the device, not at the host's dispatch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return times


def report_times(label, times):
    print(f"  {label}: median {statistics.median(times):.4f} ms, reps "
          + " ".join(f"{t:.4f}" for t in times))
    return statistics.median(times)


def lstm_inputs(gen, T, B, H, device):
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    # odd rows reset at t=0, even rows go on from h0 and c0, so both count at
    # every shape, T=1 included
    masks = torch.ones(T, B)
    masks[0, 1::2] = 0.0
    if T > 2:
        masks[T // 2, B - 1] = 0.0  # a reset inside the window
    # w_hh (H, 4H) as the transposed view of a (4H, H) tensor, the layout
    # the agent passes (weight_hh_l0.t()), so the wrapper copies nothing
    return (randn(T, B, 4 * H), masks.to(device), randn(B, H), randn(B, H),
            randn(4 * H, H, scale=H ** -0.5).t())


def lstm_bound_ms(T, B, H):
    bytes_moved = 4 * (T * B * 4 * H + T * B + 2 * B * H + 4 * H * H
                       + T * B * H + 2 * B * H)
    flops = 2 * T * B * H * 4 * H
    return bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3


def attn_bound_ms(N, Lq, S, heads, d, itemsize, flop_per_s):
    bytes_moved = itemsize * (N * Lq * heads * d * 2 + N * S * heads * d * 2)
    flops = 2 * N * heads * Lq * S * (d + d)
    return bytes_moved / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3


def rotated(fn, arg_sets):
    """fn over the argument sets in turn: each call's inputs were last touched
    len(arg_sets) - 1 calls ago, with the other sets' bytes through L2 since."""
    turns = itertools.cycle(arg_sets)
    return lambda: fn(*next(turns))


def check_lstm(gen, device):
    from robo_vln_tpu_torch.ops import fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence

    print("phase 3a: lstm_seq kernel against ops/rnn.lstm_recurrence, float32")
    worst = 0.0
    timed = {}
    # the window's and the tick's shapes, batches over several warps' tasks,
    # small hidden sizes, every count of W_hh's 16-byte chunks a lane (KC =
    # 1..8: H up to 128, 256, ..., 1024), the most rows one launch takes at
    # H=512 and H=1024, and a batch run as two launches
    for T, B, H in ((50, 4, 512), (1, 1, 512), (1, 8, 512), (2, 8, 512), (5, 20, 512),
                    (7, 11, 64), (3, 2, 32), (3, 6, 256), (3, 5, 384), (2, 3, 640),
                    (2, 3, 768), (2, 3, 896), (3, 28, 1024), (2, 56, 512), (3, 60, 512)):
        args = lstm_inputs(gen, T, B, H, device)
        before = fused_lstm.launches
        got = fused_lstm.lstm_seq_cuda(*args)
        launched = fused_lstm.launches - before
        ref = lstm_recurrence(*args)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        worst = max(worst, err)
        print(f"  T={T} B={B} H={H}: max_abs_err {err:.3e} (tolerance {LSTM_TOL}), "
              f"{launched} launch(es)")
        if launched != (2 if B > 56 else 1):
            fail(f"lstm_seq took {launched} launches at T={T} B={B} H={H}")
        if not err <= LSTM_TOL:
            fail(f"lstm_seq disagrees with its plain version at T={T} B={B} H={H}")
        call = lambda: fused_lstm.lstm_seq_cuda(*args)
        if (T, B) == (50, 4):
            kernel = report_times("kernel", time_ms(call))
            plain = report_times("plain", time_ms(lambda: lstm_recurrence(*args), inner=2))
            lstm = torch.nn.LSTM(896, H).to(device)
            x = torch.randn(T, B, 896, generator=gen).to(device)
            hc = (args[2][None], args[3][None])
            library = report_times("library nn.LSTM (cuDNN, input 896, masks all 1)",
                                   time_ms(lambda: lstm(x, hc)))
            # the same grid, T steps of nothing but the h exchange
            floor = report_times("exchange only, same grid (the exchange's floor)", time_ms(
                lambda: fused_lstm.exchange_floor_cuda(T, B, H, device)))
            print(f"  per step: kernel {kernel / T * 1e3:.3f} us, exchange "
                  f"{floor / (T - 1) * 1e3:.3f} us ({T - 1} exchanges a call)")
            timed = {"ms": kernel, "plain_ms": plain, "library_ms": library,
                     "exchange_ms": floor}
        elif (T, B) == (1, 8):  # the tick's shape
            timed["tick_ms"] = report_times("T=1 B=8 kernel", time_ms(call))
            timed["tick_host_ms"] = report_times(
                "T=1 B=8 kernel, not queued (the host's dispatch rate)",
                time_ms(call, queued=False))
    by_bytes, by_ops = lstm_bound_ms(50, 4, 512)
    print(f"  bound at T=50 B=4 H=512: bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms")
    # one window forward launches it twice at these shapes (high and low level)
    return {
        "name": "lstm_seq", "route": "cuda",
        "source": "robo_vln_tpu_torch/csrc/lstm_seq.cu",
        "replaces": "robo_vln_tpu/ops/pallas_lstm.py:40",
        "max_abs_err": worst,
        "ms": 2 * timed["ms"], "plain_ms": 2 * timed["plain_ms"],
        "bound_ms": 2 * max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes > by_ops else "operations",
        "library_ms": 2 * timed["library_ms"],
        "exchange_floor_ms": 2 * timed["exchange_ms"],
        "tick_call_ms": timed["tick_ms"], "tick_call_host_ms": timed["tick_host_ms"],
        "work": "2 calls at T=50, B=4, H=512, float32 (one window forward); "
                "exchange_floor_ms: the same grids running nothing but the h exchange; "
                "tick_call_*: one call at T=1, B=8, queued and at the host's dispatch rate",
        "library": "torch.nn.LSTM (cuDNN) over x (T, B, 896), input projection included",
    }


def check_attention(gen, device):
    from robo_vln_tpu_torch.ops import fused_attention

    print("phase 3b: cross_modal_attn kernel against ops/fused_attention.attention_plain")
    N, Lq, heads, d = 200, 200, 4, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32, bf16 = torch.float32, torch.bfloat16
    worst = dict.fromkeys(fused_attention.ROUTES, 0.0)
    sums = {"ms": 0.0, "f32_cuda_core_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bf16_ms": 0.0, "bf16_plain_ms": 0.0, "bf16_library_ms": 0.0}
    bounds = {f32: [0.0, 0.0], bf16: [0.0, 0.0]}

    def inputs(n, lq, S, h, dk, dv, dtype):
        return (torch.randn(n, lq, h * dk, generator=gen).to(device, dtype),
                torch.randn(n, S, h * dk, generator=gen).to(device, dtype),
                torch.randn(n, S, h * dv, generator=gen).to(device, dtype))

    def heads_view(q, k, v):
        return [t.view(t.shape[0], t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v)]

    def check(tag, q, k, v, h, tol, expected):
        """One launch, which must take route ``expected``, held to the plain
        version."""
        before = dict(fused_attention.route_launches)
        got = fused_attention.cross_modal_attn_cuda(q, k, v, h)
        ref = fused_attention.attention_plain(q, k, v, h)
        torch.cuda.synchronize()
        took = [r for r, count in fused_attention.route_launches.items() if count != before[r]]
        err = (got.float() - ref.float()).abs().max().item()
        print(f"  {tag} [{','.join(took)}]: max_abs_err {err:.3e} (tolerance {tol})")
        if took != [expected]:
            fail(f"cross_modal_attn launched {took} at {tag}, expected {expected}")
        if not err <= tol:
            fail(f"cross_modal_attn ({expected}) disagrees with its plain version at {tag}")
        worst[expected] = max(worst[expected], err)

    for n in (N, 8):
        for S in (16, 64):
            for dtype, tol in ((f32, ATTN_TOL), (bf16, ATTN_BF16_TOL)):
                q, k, v = inputs(n, Lq, S, heads, d, d, dtype)
                tag = f"N={n} Lq={Lq} S={S} h={heads} d={d} {str(dtype)[6:]}"
                if dtype == f32:
                    check(tag, q, k, v, heads, tol, "f32_tensor_core")
                    with cuda_core_f32_attention():
                        check(f"{tag}, CUDA-core kernel", q, k, v, heads, tol, "f32_cuda_core")
                else:
                    check(tag, q, k, v, heads, tol, "bf16")
                if n != N:
                    if dtype == bf16:  # the tick's shape
                        call = lambda: fused_attention.cross_modal_attn_cuda(q, k, v, heads)
                        report_times(f"{tag} kernel", time_ms(call))
                        report_times(f"{tag} kernel, not queued (the host's dispatch rate)",
                                     time_ms(call, queued=False))
                    continue
                # one call moves 44-108 MB against a 50 MB L2: time it over
                # several input sets in turn, so no call finds its inputs in L2
                sets = [(q, k, v)] + [inputs(n, Lq, S, heads, d, d, dtype)
                                      for _ in range(L2_ROTATION - 1)]
                note = f"inputs rotated over {L2_ROTATION} sets, not in L2"

                def timed(label, fn, arg_sets=sets):
                    return report_times(f"{tag} {label} ({note})",
                                        time_ms(rotated(fn, arg_sets)))

                prefix = "" if dtype == f32 else "bf16_"
                kernel = lambda *t: fused_attention.cross_modal_attn_cuda(*t, heads)
                sums[prefix + "ms"] += timed("kernel", kernel)
                if dtype == f32:
                    with cuda_core_f32_attention():
                        sums["f32_cuda_core_ms"] += timed("CUDA-core kernel", kernel)
                sums[prefix + "plain_ms"] += timed("plain", lambda *t: (
                    fused_attention.attention_plain(*t, heads)))
                sums[prefix + "library_ms"] += timed("library scaled_dot_product_attention",
                                                     sdpa, [heads_view(*t) for t in sets])
                if dtype == f32:
                    by_bytes, by_ops = attn_bound_ms(n, Lq, S, heads, d, 4, F32_FLOP_PER_S)
                    tc_ops = 3 * attn_bound_ms(n, Lq, S, heads, d, 4, TF32_TC_FLOP_PER_S)[1]
                    print(f"  {tag} three tf32 products on the tensor cores: {tc_ops:.4f} ms")
                else:
                    by_bytes, by_ops = attn_bound_ms(n, Lq, S, heads, d, 2, BF16_TC_FLOP_PER_S)
                print(f"  {tag} bound: bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms")
                bounds[dtype][0] += by_bytes
                bounds[dtype][1] += by_ops
    # ragged shapes, each with the route it must take: a partial query tile,
    # S below a warp, off a multiple of 8 or 16, and at the largest instance
    # (whose tiles need more than 48 KB of shared memory), other head sizes
    # (d_v != d_k in float32 only), and float32 shapes outside the
    # tensor-core kernel's range, which the CUDA-core kernel takes
    ragged = [((3, 13, 5, 2, 8, 16), f32, "f32_tensor_core"),
              ((2, 40, 33, 3, 32, 32), f32, "f32_tensor_core"),
              ((4, 65, 1, 4, 64, 64), f32, "f32_tensor_core"),
              ((2, 130, 128, 1, 128, 128), f32, "f32_tensor_core"),
              ((2, 70, 17, 2, 64, 32), f32, "f32_tensor_core"),
              ((3, 100, 100, 2, 96, 40), f32, "f32_tensor_core"),
              ((2, 40, 16, 2, 12, 12), f32, "f32_cuda_core"),
              ((2, 20, 200, 2, 16, 16), f32, "f32_cuda_core"),
              ((3, 13, 5, 2, 16, 16), bf16, "bf16"),
              ((2, 40, 33, 3, 32, 32), bf16, "bf16"),
              ((4, 65, 1, 4, 48, 48), bf16, "bf16"),
              ((2, 130, 128, 1, 128, 128), bf16, "bf16")]
    for (n, lq, S, h, dk, dv), dtype, route in ragged:
        tag = f"N={n} Lq={lq} S={S} h={h} d_k={dk} d_v={dv} {str(dtype)[6:]}"
        check(tag, *inputs(n, lq, S, h, dk, dv, dtype), h,
              ATTN_TOL if dtype == f32 else ATTN_BF16_TOL, route)
    # one window forward launches it twice: S=16 (rgb) and S=64 (depth)
    (f32_bytes, f32_ops), (bf16_bytes, bf16_ops) = bounds[f32], bounds[bf16]
    return {
        "name": "cross_modal_attn", "route": "cuda",
        "source": "robo_vln_tpu_torch/csrc/cross_modal_attn.cu",
        "replaces": "robo_vln_tpu/ops/pallas_attention.py:48",
        "max_abs_err": worst["f32_tensor_core"],
        "f32_cuda_core_max_abs_err": worst["f32_cuda_core"],
        "bf16_max_abs_err": worst["bf16"],
        **sums,
        "bound_ms": max(f32_bytes, f32_ops),
        "bound_by": "bytes" if f32_bytes > f32_ops else "operations",
        "bf16_bound_ms": max(bf16_bytes, bf16_ops),
        "bf16_bound_by": "bytes" if bf16_bytes > bf16_ops else "operations",
        "work": "2 calls, N=200 Lq=200 h=4 d=64 at S=16 and S=64 (one window forward), "
                f"inputs rotated over {L2_ROTATION} sets so that none is in L2; the "
                "unprefixed fields float32 on the tensor cores (3xTF32, the route every "
                "float32 call at these shapes takes), f32_cuda_core_* the float32 "
                "CUDA-core kernel at the same shapes, bf16_* bfloat16; bound_ms counts "
                "float32 operations at the CUDA cores' peak",
        "library": "torch.nn.functional.scaled_dot_product_attention on head views",
    }


def check_wider_shapes(gen, device):
    """Phase 3c: one call of each shape past a kernel's former range, which
    must launch that kernel once (by the route it names) and match the
    plain version; the bf16 kernel timed at the 384 px frame's S=144 over
    the window's N; and the calls no kernel takes, which must raise before
    any launch.  Returns the S=144 timing fields."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence

    print("phase 3c: shapes past the kernels' former ranges, and shapes no kernel takes")
    f32, bf16 = torch.float32, torch.bfloat16

    def held(tag, module, call, plain, tol, route=None):
        routes = dict(getattr(module, "route_launches", {}))
        before = module.launches
        got, ref = call(), plain()
        torch.cuda.synchronize()
        took = [r for r, n in getattr(module, "route_launches", {}).items() if n != routes[r]]
        pairs = zip(*(x if isinstance(x, tuple) else (x,) for x in (got, ref)))
        err = max((g.float() - r.float()).abs().max().item() for g, r in pairs)
        print(f"  {tag} [{','.join(took) or 'kernel'}]: max_abs_err {err:.3e} "
              f"(tolerance {tol})")
        if module.launches - before != 1 or (route is not None and took != [route]):
            fail(f"{tag} launched {module.launches - before} kernels by {took}, "
                 f"expected one by {route or 'the kernel'}")
        if not err <= tol:
            fail(f"{tag} disagrees with the plain version")

    def refused(tag, module, call):
        before = module.launches
        try:
            call()
        except ValueError as e:
            print(f"  {tag}: refused before any launch ({e})")
        else:
            fail(f"{tag} was not refused")
        if module.launches != before:
            fail(f"{tag} launched a kernel")

    def qkv(n, lq, S, h, d, dtype):
        return [torch.randn(n, L, h * d, generator=gen).to(device, dtype)
                for L in (lq, S, S)]

    for S, dtype, d, tol, route in ((144, bf16, 64, ATTN_BF16_TOL, "bf16"),
                                    (300, bf16, 128, ATTN_BF16_TOL, "bf16"),
                                    (500, f32, 64, ATTN_TOL, "f32_cuda_core")):
        q, k, v = qkv(8, 200, S, 4, d, dtype)
        held(f"cross_modal_attn N=8 Lq=200 S={S} h=4 d={d} {str(dtype)[6:]}", fused_attention,
             lambda: fused_attention.cross_modal_attn_cuda(q, k, v, 4),
             lambda: fused_attention.attention_plain(q, k, v, 4), tol, route)
    for T, B in ((5, 4), (50, 4)):
        args = lstm_inputs(gen, T, B, 556, device)
        held(f"lstm_seq T={T} B={B} H=556", fused_lstm, lambda: fused_lstm.lstm_seq_cuda(*args),
             lambda: lstm_recurrence(*args), LSTM_TOL)

    n = 8 * 200 * 256
    q, k, v = (torch.randn(n + 8, generator=gen).to(device, bf16)[1:n + 1].view(8, 200, 256)
               for _ in range(3))
    refused("cross_modal_attn bfloat16 with pointers off a 16-byte boundary", fused_attention,
            lambda: fused_attention.cross_modal_attn_cuda(q, k, v, 4))
    args = lstm_inputs(gen, 2, 2, 1028, device)
    refused("lstm_seq H=1028", fused_lstm, lambda: fused_lstm.lstm_seq_cuda(*args))

    # the depth attention of a 384 px frame at the window's size
    N, Lq, S, heads, d = 200, 200, 144, 4, 64
    sets = [qkv(N, Lq, S, heads, d, bf16) for _ in range(L2_ROTATION)]
    note = f"inputs rotated over {L2_ROTATION} sets, not in L2"
    tag = f"N={N} Lq={Lq} S={S} h={heads} d={d} bfloat16"
    timed = {
        "bf16_s144_ms": report_times(f"{tag} kernel ({note})", time_ms(rotated(
            lambda *t: fused_attention.cross_modal_attn_cuda(*t, heads), sets))),
        "bf16_s144_plain_ms": report_times(f"{tag} plain ({note})", time_ms(rotated(
            lambda *t: fused_attention.attention_plain(*t, heads), sets))),
        "bf16_s144_library_ms": report_times(
            f"{tag} library scaled_dot_product_attention ({note})", time_ms(rotated(
                torch.nn.functional.scaled_dot_product_attention,
                [[t.view(N, t.shape[1], heads, d).transpose(1, 2) for t in ts]
                 for ts in sets]))),
    }
    by_bytes, by_ops = attn_bound_ms(N, Lq, S, heads, d, 2, BF16_TC_FLOP_PER_S)
    print(f"  {tag} bound: bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms")
    timed["bf16_s144_bound_ms"] = max(by_bytes, by_ops)
    timed["bf16_s144_work"] = (f"one call, {tag} (the depth attention of a 384 px frame), "
                               f"{note}; bound by {'bytes' if by_bytes > by_ops else 'operations'}")
    return timed


@contextlib.contextmanager
def cuda_core_f32_attention():
    """Route float32 attention to the CUDA-core kernel, to check and time
    it against the tensor-core kernel at the same shapes."""
    from robo_vln_tpu_torch.ops import fused_attention

    saved = fused_attention.pick_route
    fused_attention.pick_route = lambda dtype, *a, **kw: (
        "f32_cuda_core" if dtype == torch.float32 else saved(dtype, *a, **kw))
    try:
        yield
    finally:
        fused_attention.pick_route = saved


@contextlib.contextmanager
def plain_kernels():
    """Swap both kernels for their plain versions, for the comparison only."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence

    saved = fused_lstm.lstm_seq_cuda, fused_attention.cross_modal_attn_cuda
    fused_lstm.lstm_seq_cuda = lstm_recurrence
    fused_attention.cross_modal_attn_cuda = fused_attention.attention_plain
    try:
        yield
    finally:
        fused_lstm.lstm_seq_cuda, fused_attention.cross_modal_attn_cuda = saved


def window_inputs(gen, B, T, L, device):
    obs = {
        "rgb": torch.randint(0, 256, (B, T, 224, 224, 3), generator=gen, dtype=torch.uint8),
        "depth": torch.rand(B, T, 256, 256, 1, generator=gen).half(),
        "instruction": torch.randint(1, 30522, (B, L), generator=gen),
    }
    masks = torch.ones(B, T)
    masks[:, 0] = 0.0
    return {k: v.to(device) for k, v in obs.items()}, masks.to(device)


def check_finite(name, *tensors):
    for t in tensors:
        if not torch.isfinite(t.float()).all():
            fail(f"{name}: non-finite output")


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or event.self_cuda_time_total


def profile_section(label, fn, top=12, ranges=()):
    """torch.profiler over fn: wall ms, summed kernel time, busy share and
    the kernels taking the most device time; then, for each named profiler
    range, its host time and the device time of the kernels launched in it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # profiler ranges are mirrored on the device's timeline as spans: not kernels
    kernels = [e for e in averages if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(f"  profile {label}: wall {wall_ms:.3f} ms, kernel time {device_ms:.3f} ms, "
          f"device busy {device_ms / wall_ms:.3f}, {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"    {_device_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:100]}")
    for name in ranges:
        host = [e.cpu_time_total for e in averages
                if e.key == name and e.device_type.name == "CPU"]
        span = [_device_us(e) for e in averages
                if e.key == name and e.device_type.name == "CUDA"]
        count = sum(e.count for e in averages if e.key == name and e.device_type.name == "CPU")
        print(f"    range {name}: {count}x, host {sum(host) / 1e3:.3f} ms, device span "
              + (f"{sum(span) / 1e3:.3f} ms" if span else "none recorded"))


def profile_main_path(agent, obs, masks, tick_obs, tick_masks):
    print("phase 4c: torch.profiler over one window and five ticks")
    B = masks.shape[0]
    profile_section("window B=4 T=50", lambda: agent.forward_window(
        obs, masks, None, *agent.initial_state(B)))

    def ticks():
        state = agent.initial_state(8)
        for t in range(5):
            tick = {"rgb": tick_obs["rgb"][:, t], "depth": tick_obs["depth"][:, t],
                    "instruction": tick_obs["instruction"]}
            state = agent.act(tick, state, None, tick_masks[:, t])[2]

    profile_section("5 ticks B=8", ticks)


def main_path(device, profile=False):
    from robo_vln_tpu_torch import build_hcm_agent
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm

    cfg = get_config()
    mc = cfg.MODEL
    print("phase 4: HCM agent at full width: BERT-base 12x768, TV-ResNet50 224 px, "
          "GN-ResNet50 256 px, VisualLingAttn 256/4h, LSTM(512); bfloat16")
    t0 = time.perf_counter()
    agent = build_hcm_agent(mc, device=device, compute_dtype=cfg.TPU.PRECISION, seed=0,
                            share_frozen_trunks=cfg.TPU.SHARE_FROZEN_TRUNKS)
    torch.cuda.synchronize()
    print(f"  build: {time.perf_counter() - t0:.2f} s, shared trunks: {agent.trunk_fn is not None}")
    if agent.trunk_fn is None:
        fail("the synced trunks did not take the shared-trunk path")

    gen = torch.Generator().manual_seed(1)
    B, T, L = 4, 50, 200
    obs, masks = window_inputs(gen, B, T, L, device)
    tick_obs, tick_masks = window_inputs(gen, 8, 10, L, device)
    torch.cuda.reset_peak_memory_stats()

    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    for rep in range(3):
        t0 = time.perf_counter()
        hh, lh = agent.initial_state(B)
        actions, stop, logits, hh, lh = agent.forward_window(obs, masks, None, hh, lh)
        torch.cuda.synchronize()
        print(f"  window B={B} T={T} rep {rep}: {(time.perf_counter() - t0) * 1e3:.3f} ms")
    check_finite("forward_window", actions, stop, logits, hh, lh)
    if (actions.shape, stop.shape, logits.shape, hh.shape) != (
            (B, T, 2), (B, T, 1), (B, T, 4), (2, B, 512)):
        fail("forward_window output shapes")
    state = agent.initial_state(8)
    for t in range(10):
        tick = {"rgb": tick_obs["rgb"][:, t], "depth": tick_obs["depth"][:, t],
                "instruction": tick_obs["instruction"]}
        t0 = time.perf_counter()
        a, s, state = agent.act(tick, state, None, tick_masks[:, t])
        torch.cuda.synchronize()
        print(f"  act tick {t} B=8: {(time.perf_counter() - t0) * 1e3:.3f} ms")
        check_finite("act", a, s, *state)
    launches = {"lstm_seq": fused_lstm.launches, "cross_modal_attn": fused_attention.launches}
    print(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches on the main path: {launches}")
    expected = 2 * (3 + 10)  # high + low LSTM, rgb + depth attention, per forward
    for name, count in launches.items():
        if count != expected:
            fail(f"{name} launched {count} times on the main path, expected {expected}")

    if profile:
        profile_main_path(agent, obs, masks, tick_obs, tick_masks)

    print("phase 4b: float32 window, timed against the same window with the float32 "
          "CUDA-core attention kernel, then kernels against plain versions; global TF32 "
          f"flags: cudnn {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} (the agent turns both off for its calls)")
    agent32 = build_hcm_agent(mc, device=device, compute_dtype="float32", seed=0)
    times = {"f32_tensor_core": [], "f32_cuda_core": []}
    for rep in range(3):
        for route, ms in times.items():
            before = dict(fused_attention.route_launches)
            forced = route == "f32_cuda_core"
            with cuda_core_f32_attention() if forced else contextlib.nullcontext():
                t0 = time.perf_counter()
                out = agent32.forward_window(obs, masks, None, *agent32.initial_state(B))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            took = {r: c - before[r] for r, c in fused_attention.route_launches.items()}
            print(f"  float32 window B={B} T={T} rep {rep}, attention {route}: {ms[-1]:.3f} ms")
            if took != {r: 2 if r == route else 0 for r in took}:
                fail(f"the float32 window launched {took}, expected 2 of {route}")
            if route == "f32_tensor_core":
                got = out
    print("  float32 window medians: " + ", ".join(
        f"attention {route} {statistics.median(ms):.3f} ms" for route, ms in times.items()))
    with plain_kernels():
        ref = agent32.forward_window(obs, masks, None, *agent32.initial_state(B))
    top2 = ref[2].topk(2, dim=-1).values
    print(f"  smallest top-2 logit gap: {(top2[..., 0] - top2[..., 1]).min().item():.3e}")
    names = ("actions", "stop", "logits", "high hidden", "low hidden")
    for name, g, r in zip(names, got, ref):
        check_finite(f"float32 {name}", g)
        err = (g - r).abs().max().item()
        print(f"  {name}: max_abs_err {err:.3e} (tolerance {WINDOW_TOL})")
        if not err <= WINDOW_TOL:
            fail(f"float32 window {name} disagrees with the plain-kernel agent")
    return launches


def train_batch(gen, B, T, L, device):
    """The bench's batch (bench.py:226-240): oracle sub-goals in 1-4,
    corrected actions uniform in [0, 1), stop targets (u > 0.7), masks with
    column 0 at 0, every step valid."""
    obs, masks = window_inputs(gen, B, T, L, device)
    labels = {
        "vln_oracle_action_sensor": torch.randint(1, 5, (B, T), generator=gen).float(),
        "prev_actions": torch.zeros(B, T, 2),
        "corrected_actions": torch.rand(B, T, 2, generator=gen),
        "oracle_stop": (torch.rand(B, T, 1, generator=gen) > 0.7).float(),
        "valid_mask": torch.ones(B, T),
    }
    return {**obs, **{k: v.to(device) for k, v in labels.items()}, "not_done_masks": masks}


def make_train(cfg, dtype, device):
    """(high, low, step, state): both policies at full width with random
    weights from seed 0 and synced trunks, the step as the config sets it,
    AdamW (weight decay 1e-5) and Adam (none) as bench.py:191-192 sets them."""
    from robo_vln_tpu_torch.models import (
        build_hierarchical_policies, make_shared_trunk_fn, sync_frozen_trunks)
    from robo_vln_tpu_torch.training import (
        HierTrainState, TrainState, adam, adamw, inflection_coef_from, make_hier_train_step)

    high, low = build_hierarchical_policies(cfg.MODEL, compute_dtype=dtype,
                                            generator=torch.Generator().manual_seed(0))
    sync_frozen_trunks(high, low)
    high, low = high.to(device), low.to(device)
    step = make_hier_train_step(
        high, low, trunk_fn=make_shared_trunk_fn(high), remat=cfg.TPU.REMAT,
        inflection_coef=inflection_coef_from(cfg),
        valid_velocity_mse=cfg.TPU.VALID_MASK_VELOCITY_MSE)
    state = HierTrainState(TrainState(adamw(high, 1e-5), 0), TrainState(adam(low, 0.0), 0))
    return high, low, step, state


def train_path(device, profile=False):
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.training import trainable_mask

    cfg = get_config()
    B, T, L, lr = 4, 50, 200, 1e-4
    print(f"phase 5: hierarchical train step at full width, bfloat16, B={B} T={T}, "
          f"AdamW (wd 1e-5) high, Adam (wd 0) low, lr {lr}")
    t0 = time.perf_counter()
    high, low, step, state = make_train(cfg, torch.bfloat16, device)
    torch.cuda.synchronize()
    print(f"  build: {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator().manual_seed(2)
    batch = train_batch(gen, B, T, L, device)
    named = [(f"{level}.{n}", p, mask[n]) for level, pol in (("high", high), ("low", low))
             for mask in (trainable_mask(pol),) for n, p in pol.named_parameters()]
    before = {n: p.detach().clone() for n, p, _ in named}
    hh, lh = high.initial_hidden(B, device), low.initial_hidden(B, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    step_ms = []
    for i in range(TRAIN_STEPS):
        counts = (fused_lstm.launches, fused_attention.launches,
                  fused_attention.route_launches["bf16"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, hh, lh, metrics = step(state, hh, lh, batch, lr, lr)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        step_ms.append(host_ms)
        print(f"  train step {i}: {start.elapsed_time(end):.3f} ms (CUDA events), "
              f"{host_ms:.3f} ms (host clock); " + ", ".join(
                  f"{k} {v.item():.4f}" for k, v in metrics.items()))
        check_finite("train step", *metrics.values(), hh, lh)
        launched = tuple(n - c for n, c in zip(
            (fused_lstm.launches, fused_attention.launches,
             fused_attention.route_launches["bf16"]), counts))
        if launched != (2, 2, 2):
            fail(f"train step {i} launched (lstm_seq, cross_modal_attn, of it bf16) "
                 f"{launched}, expected (2, 2, 2)")
    launches = {"lstm_seq": fused_lstm.launches, "cross_modal_attn": fused_attention.launches}
    print(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches on the train path: {launches}")
    unused = []
    for name, p, trainable in named:
        same = torch.equal(p, before[name])
        if not trainable and not same:
            fail(f"frozen parameter {name} changed")
        if not trainable:
            continue
        if p.grad is None:  # only the progress monitors, which nothing calls
            if ".progress_monitor." not in name or not same:
                fail(f"trainable parameter {name} got no gradient")
            unused.append(name)
        elif same:
            fail(f"trainable parameter {name} did not move")
    print(f"  {sum(not t for _, _, t in named)} frozen parameters unchanged, "
          f"{sum(t for _, _, t in named) - len(unused)} trainable ones moved, "
          f"{len(unused)} without a gradient, unchanged (the unused progress monitors)")
    if profile:
        profile_section(f"train step B={B} T={T}",
                        lambda: step(state, hh, lh, batch, lr, lr), top=16,
                        ranges=("hier_train_step.forward", "hier_train_step.backward",
                                "lstm_seq.backward_replay", "cross_modal_attn.backward_replay",
                                "hier_train_step.optimizer"))
    del high, low, step, state, before, named

    print("phase 5b: float32 train step against the same step with both kernels "
          "swapped for their plain versions (lr 0, global TF32 flags at their defaults)")
    high, low, step, state = make_train(cfg, torch.float32, device)
    hh, lh = high.initial_hidden(B, device), low.initial_hidden(B, device)
    params = [(f"{level}.{n}", p) for level, pol in (("high", high), ("low", low))
              for n, p in pol.named_parameters()]
    runs = {}
    for label, scope in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
        for rep in range(2):
            routes = dict(fused_attention.route_launches)
            with scope():
                t0 = time.perf_counter()
                _, _, _, metrics = step(state, hh, lh, batch, 0.0, 0.0)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            grads = {n: p.grad.clone() for n, p in params if p.grad is not None}
            print(f"  float32 train step, {label}, rep {rep}: {ms:.3f} ms (host clock)")
            took = {r: n - routes[r] for r, n in fused_attention.route_launches.items()
                    if n != routes[r]}
            if label == "kernels" and took != {"f32_tensor_core": 2}:
                fail(f"the float32 train step took attention routes {took}")
        runs[label] = metrics, grads
    (got, got_grads), (ref, ref_grads) = runs["kernels"], runs["plain"]
    for key in ("high_level_loss", "low_level_action_loss", "low_level_stop_loss"):
        rel = abs(got[key].item() - ref[key].item()) / abs(ref[key].item())
        print(f"  {key}: {got[key].item():.6f} against {ref[key].item():.6f}, relative "
              f"{rel:.3e} (tolerance {TRAIN_LOSS_RTOL})")
        if not rel <= TRAIN_LOSS_RTOL:
            fail(f"float32 train step {key} disagrees with the plain-kernel step")
    print(f"  high_level_accuracy: {got['high_level_accuracy'].item():.4f} against "
          f"{ref['high_level_accuracy'].item():.4f}")
    if got_grads.keys() != ref_grads.keys():
        fail("the two runs gave gradients to different parameters")
    worst = {"leaf": (0.0, None), "zero": (0.0, None)}
    for name, g in got_grads.items():
        r = ref_grads[name]
        check_finite(f"float32 gradient of {name}", g)
        if name.endswith(ZERO_GRAD_LEAF):
            # exactly 0: what both runs compute is rounding noise, held far
            # below the gradient of the same projection's weight
            kind = "zero"
            err = max(g.abs().max(), r.abs().max()).item() / ref_grads[
                name[:-len("bias")] + "weight"].norm().item()
        else:
            kind = "leaf"
            err = (g - r).abs().max().item() / max(r.norm().item(), 1e-30)
        if err > worst[kind][0]:
            worst[kind] = err, name
    print(f"  gradients: largest error {worst['leaf'][0]:.3e} of its leaf's norm, at "
          f"{worst['leaf'][1]} (tolerance {TRAIN_GRAD_TOL}), over {len(got_grads)} leaves; "
          f"the key biases, whose exact gradient is 0: largest value {worst['zero'][0]:.3e} "
          f"of the key weight's gradient norm, at {worst['zero'][1]} (tolerance {TRAIN_GRAD_TOL})")
    for err, name in worst.values():
        if not err <= TRAIN_GRAD_TOL:
            fail(f"float32 train step gradient of {name} disagrees with the plain-kernel step")
    return launches, step_ms


def write_trainer_buffers(root):
    """The synthetic expert buffers of phase 6, written with the port's own
    writer: 8 train episodes of 60-100 steps in the msgpack format and 4
    eval episodes in the flat format; rgb 224 px uint8, depth 256 px
    float16, 200 BERT ids, float64 actions.  Returns their bytes on disk."""
    import numpy as np

    from robo_vln_tpu_torch.data.loader import write_episode
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore

    rng = np.random.default_rng(3)
    for name, episodes, flat in (("train", TRAINER_EPISODES, False),
                                 ("eval", TRAINER_EVAL_EPISODES, True)):
        with TrajectoryStore(os.path.join(root, name), writable=True) as store:
            for key in range(episodes):
                t = int(rng.integers(60, 101))
                obs = {
                    "rgb": rng.integers(0, 256, (t, 224, 224, 3), dtype=np.uint8),
                    "depth": rng.random((t, 256, 256, 1), dtype=np.float32).astype(np.float16),
                    "vln_oracle_action_sensor": rng.integers(1, 5, (t, 1)).astype(np.float64),
                    "instruction": np.tile(rng.integers(1, 30522, (1, 200)), (t, 1)).astype(
                        np.int32),
                }
                stop = t - int(rng.integers(1, 10))
                write_episode(store, key, obs, rng.standard_normal((t, 2)),
                              rng.random((t, 2)), [stop] * t, flat=flat)
    return dir_bytes(root)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


@contextlib.contextmanager
def instrumented_trainer(record):
    """Time and count what the hierarchical trainer does, from outside it:
    after ``_setup_policy`` each new trainer's ``train_step`` and ``val_step``
    are wrapped (host time to the end of the device's work, the gap since
    the last step, the launches of each kernel), and ``train_epoch``,
    ``val_epoch`` and ``save_checkpoint`` are timed."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.training import trainable_mask
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer as HT

    def counts():
        return fused_lstm.launches, fused_attention.launches

    def timed_call(kind, fn):
        def call(*args):
            before, t0 = counts(), time.perf_counter()
            if kind == "train" and record["last_end"] is not None:
                record["gaps_ms"].append((t0 - record["last_end"]) * 1e3)
            if kind == "train":
                record["first_steps"].append(args[0].high.step)
            out = fn(*args)
            torch.cuda.synchronize()
            end = time.perf_counter()
            record[f"{kind}_ms"].append((end - t0) * 1e3)
            launched = tuple(n - c for n, c in zip(counts(), before))
            if launched != (2, 2):
                fail(f"a {kind} call of the trainer launched (lstm_seq, cross_modal_attn) "
                     f"{launched}, expected (2, 2)")
            if kind == "train":
                record["last_end"] = end
            return out
        return call

    def timed_method(name, key):
        original = getattr(HT, name)

        def method(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = original(self, *args, **kwargs)
            torch.cuda.synchronize()
            record[key].append((time.perf_counter() - t0) * 1e3)
            if name == "train_epoch":
                record["last_end"] = None
            return out
        return original, method

    setup = HT._setup_policy

    def setup_and_wrap(self, *args, **kwargs):
        setup(self, *args, **kwargs)
        if not record["wrap"]:
            return
        record["trainers"].append(self)
        record["shared_trunks"].append(self.trunk_fn is not None)
        if len(record["trainers"]) == 1:  # the first run's frozen weights, to hold
            record["frozen"] = {
                (level, n): p.detach().clone() for level, pol in (("high", self.high),
                                                                  ("low", self.low))
                for mask in (trainable_mask(pol),) for n, p in pol.named_parameters()
                if not mask[n]}
        self.train_step = timed_call("train", self.train_step)
        self.val_step = timed_call("val", self.val_step)

    saved = {name: timed_method(name, key) for name, key in (
        ("train_epoch", "epoch_ms"), ("val_epoch", "val_epoch_ms"),
        ("save_checkpoint", "save_ms"))}
    try:
        HT._setup_policy = setup_and_wrap
        for name, (_, method) in saved.items():
            setattr(HT, name, method)
        yield
    finally:
        HT._setup_policy = setup
        for name, (original, _) in saved.items():
            setattr(HT, name, original)


def check_round_trip(trainer, path, cfg):
    """Load ``path`` into a fresh trainer of ``cfg`` and hold it bitwise to
    ``trainer``'s state in memory: parameters and buffers, both optimizers'
    state, both step counters.  Returns the load's ms."""
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer

    fresh = HierarchicalTrainer(cfg)
    fresh._setup_policy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.state = ckpt_lib.load_checkpoint(path, fresh.high, fresh.low, fresh.state)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    tensors = 0
    for level in ("high", "low"):
        got, want = getattr(fresh, level).state_dict(), getattr(trainer, level).state_dict()
        if got.keys() != want.keys():
            fail(f"the {level} level's reloaded state_dict has other keys")
        for k, v in want.items():
            if not torch.equal(got[k], v):
                fail(f"{path}: {level} {k} differs from the saving trainer's")
        got_opt = getattr(fresh.state, level).optimizer
        want_opt = getattr(trainer.state, level).optimizer
        for p_got, p_want in zip(
                (p for g in got_opt.param_groups for p in g["params"]),
                (p for g in want_opt.param_groups for p in g["params"])):
            for k, v in want_opt.state[p_want].items():
                if not torch.equal(got_opt.state[p_got][k], v):
                    fail(f"{path}: the {level} level's optimizer state {k} differs")
                tensors += 1
        if getattr(fresh.state, level).step != getattr(trainer.state, level).step:
            fail(f"{path}: the {level} level's step counter differs")
        tensors += len(want)
    del fresh
    return load_ms, tensors


def trainer_path(device, bare_step_ms, profile=False):
    """Phase 6: python -m robo_vln_tpu_torch.run's train path, twice through
    run_exp at full width on the card, the second run resuming the first."""
    import shutil
    import tempfile

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib

    print("phase 6: the hierarchical trainer at full width, bfloat16, B=4, tbptt 50: "
          "python -m robo_vln_tpu_torch.run's run_exp twice (epoch 0, then a resumed epoch 1)")
    from robo_vln_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    root = tempfile.mkdtemp(prefix="trainer_", dir=_build.BUILD_DIR.parent)
    try:
        t0 = time.perf_counter()
        data_bytes = write_trainer_buffers(root)
        print(f"  buffers: {TRAINER_EPISODES} train episodes (msgpack), "
              f"{TRAINER_EVAL_EPISODES} eval episodes (flat), {data_bytes / 2**20:.1f} MiB, "
              f"written in {time.perf_counter() - t0:.2f} s")
        opts = ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer",
                "DAGGER.BATCH_SIZE", 4, "DAGGER.tbptt_steps", 50,
                "DAGGER.EPISODE_LEN_BUCKETS", [100], "DAGGER.EPOCHS", 2,
                "DAGGER.MAX_EPOCHS_PER_RUN", 1, "DAGGER.RESUME", True,
                "DAGGER.PRELOAD_LMDB_FEATURES", True,
                "DAGGER.LMDB_FEATURES_DIR", os.path.join(root, "train"),
                "DAGGER.LMDB_EVAL_DIR", os.path.join(root, "eval"),
                "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"),
                "TENSORBOARD_DIR", os.path.join(root, "tb"),
                "LOG_FILE", os.path.join(root, "train.log"),
                "MODEL.INSTRUCTION_ENCODER.is_bert", True,
                "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", "bfloat16"]
        cfg = get_config(opts=opts)
        record = {k: [] for k in ("trainers", "shared_trunks", "train_ms", "val_ms", "gaps_ms",
                                  "first_steps", "epoch_ms", "val_epoch_ms", "save_ms")}
        record["last_end"], record["wrap"] = None, True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_lstm.reset_launches()
        fused_attention.reset_launches()
        with instrumented_trainer(record):
            t0 = time.perf_counter()
            run_exp(None, "train", opts)
            run1_ms = (time.perf_counter() - t0) * 1e3
            trainer = record["trainers"][0]
            peak1 = torch.cuda.max_memory_allocated()
            changed = [k for k, v in record.pop("frozen").items()
                       if not torch.equal(getattr(trainer, k[0]).get_parameter(k[1]), v)]
            if changed:
                fail(f"frozen parameters changed in training: {changed[:5]}")
            ckpt2 = os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.2")
            if ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER) != [ckpt2]:
                fail(f"run 1 wrote {ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)}")
            record["wrap"] = False  # the fresh trainer is not a run's
            load_ms, tensors = check_round_trip(trainer, ckpt2, cfg)
            record["wrap"] = True
            del trainer
            record["trainers"].clear()
            t0 = time.perf_counter()
            if profile:
                profile_section("trainer run 2 (resume, one epoch and its validation)",
                                lambda: run_exp(None, "train", opts), top=16,
                                ranges=("hier_train_step.forward", "hier_train_step.backward",
                                        "lstm_seq.backward_replay",
                                        "hier_train_step.optimizer"))
            else:
                run_exp(None, "train", opts)
            run2_ms = (time.perf_counter() - t0) * 1e3
        launches = {"lstm_seq": fused_lstm.launches, "cross_modal_attn": fused_attention.launches}
        record["trainers"].clear()
        ckpts = ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)
        meta = ckpt_lib.load_metadata(ckpts[-1])
        if [os.path.basename(c) for c in ckpts] != ["ckpt.2", "ckpt.3"] or \
                meta["train_steps"] != 8:
            fail(f"run 2 did not resume to ckpt.3 with 8 train steps: {ckpts}, {meta}")
        if record["first_steps"][4] != 4:
            fail(f"run 2's first step ran at step {record['first_steps'][4]}, not 4")
        if record["shared_trunks"] != [True, True]:
            fail(f"the trainers did not share their trunks: {record['shared_trunks']}")
        with open(os.path.join(cfg.TENSORBOARD_DIR, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses = [m for m in logged if "Loss" in m["tag"]]
        if len([m for m in losses if m["tag"].startswith("Train")]) != 4 * 8 or not all(
                math.isfinite(m["value"]) for m in losses):
            fail("the trainer's logged losses are not 4 finite values a step over 8 steps")
        if (len(record["train_ms"]), len(record["val_ms"])) != (8, 4):
            fail(f"{len(record['train_ms'])} train steps and {len(record['val_ms'])} val "
                 "windows, expected 8 and 4")
        if launches != {"lstm_seq": 24, "cross_modal_attn": 24}:
            fail(f"the trainer path launched {launches}, expected 24 of each")
        ckpt_bytes = dir_bytes(ckpt2)
        peak = torch.cuda.max_memory_allocated()
        steps = record["train_ms"]
        print(f"  run 1 (build, epoch 0, validation): {run1_ms:.1f} ms; run 2 (resume from "
              f"ckpt.2, epoch 1, validation): {run2_ms:.1f} ms; shared trunks: "
              f"{record['shared_trunks']}")
        print("  train steps, host ms to the end of the device's work: "
              + " ".join(f"{t:.3f}" for t in steps))
        print("  gaps between steps inside an epoch (loader wait, logging), ms: "
              + " ".join(f"{t:.3f}" for t in record["gaps_ms"]))
        print("  train epochs (checkpoint save included), ms: "
              + " ".join(f"{t:.1f}" for t in record["epoch_ms"]))
        print("  checkpoint saves, ms: " + " ".join(f"{t:.1f}" for t in record["save_ms"])
              + f"; ckpt.2 on disk {ckpt_bytes / 2**20:.1f} MiB")
        print(f"  checkpoint load into a fresh trainer: {load_ms:.1f} ms, {tensors} tensors "
              "bitwise equal to the saving trainer's (parameters, buffers, Adam state)")
        print("  val windows, ms: " + " ".join(f"{t:.3f}" for t in record["val_ms"])
              + "; val epochs, ms: " + " ".join(f"{t:.1f}" for t in record["val_epoch_ms"]))
        inner = [t for i, t in enumerate(steps) if i % 4]  # not the first step of a run
        print(f"  steps 2-4 of each run: median {statistics.median(inner):.3f} ms against "
              f"phase 5's bare step, steps 1-4: median {statistics.median(bare_step_ms[1:]):.3f} ms")
        print(f"  peak device memory: run 1 {peak1 / 2**30:.3f} GiB, both runs "
              f"{peak / 2**30:.3f} GiB")
        print(f"  launches on the trainer path: {launches} (2 a train step and a val window)")
        print(f"  run 2 started at step {record['first_steps'][4]} and wrote ckpt.3 with "
              f"train_steps {meta['train_steps']}, scheduler_step {meta['scheduler_step']}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from robo_vln_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e})", file=sys.stderr)
        return 1
    from robo_vln_tpu_torch.utils.device import float32_exact

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase 2: built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in logs.items():
        for kernel, regs, spill in ptxas_usage(log):
            print(f"  {name}: {kernel}: {regs} registers, {spill} bytes spill stores")
            if kernel.startswith("cross_modal_attn_f32tc_kernel") and spill:
                fail(f"{kernel} spills {spill} bytes")

    gen = torch.Generator().manual_seed(0)
    with float32_exact(torch.float32):  # the float32 plain versions without TF32
        kernels = [check_lstm(gen, device), check_attention(gen, device)]
        kernels[1].update(check_wider_shapes(gen, device))
    profile = "--profile" in sys.argv[1:]
    launches = main_path(device, profile)
    train_launches, bare_step_ms = train_path(device, profile)
    trainer_launches = trainer_path(device, bare_step_ms, profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["train_launches"] = train_launches[k["name"]]
        k["trainer_launches"] = trainer_launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
