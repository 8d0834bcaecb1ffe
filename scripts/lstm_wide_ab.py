#!/usr/bin/env python3
"""Time the LSTM's wide kernels of several checkouts of the repo on one CUDA
card, in turns, one process each, and compare their narrow instances'
machine code.

    python3 scripts/lstm_wide_ab.py [--out FILE] [--sass-only] TREE [TREE ...]

Each TREE is the root of a checkout: this one, or another commit unpacked
with ``git archive`` into a directory that .gitignore lists.  A tree's
process imports that tree's own ``robo_vln_tpu_torch`` and ``chip_smoke``,
builds its LSTM kernels into the tree's ``build/kernels/``, holds the wide
forward and the wide backward at phase 14's shape (T=50, B=4, H=2048,
float32, TF32 off) against the plain versions, and times with CUDA events
(``chip_smoke.time_ms``: 10 reps of 10 calls, each rep queued behind a
device sleep):

* the forward's whole call (``lstm_seq_cuda``) and its launch alone (the C
  entry on buffers made once), and, where the tree has its entry, its grid
  running nothing but the h exchange (``exchange_floor_cuda``);
* the backward's whole call (``lstm_seq_backward_cuda``, no masks'
  gradient: the gates recomputed, the kernel, d_w_hh), its launch alone
  (``_backward_launch``) and, where the tree has its entry, its exchange
  alone (``backward_exchange_floor_cuda``);
* cuDNN's ``nn.LSTM(896, 2048)`` forward, and its forward and backward.

Each time is also given per step (a forward call makes T steps and T - 1
exchanges, a backward call T reverse steps).  It also hashes the SASS
(``cuobjdump -sass``) of every instance of the narrow kernels
(``lstm_seq_kernel``, ``lstm_seq_backward_kernel``,
``lstm_seq_backward_partials_kernel``), which carry every H up to 1024 at 8
units a block (branch labels, which cuobjdump numbers across the library,
offsets into constant banks 2 and 4, which other kernels shift, and the
padding of its columns left out; ``--sass-only`` skips the timings).

Prints one JSON line a tree, in the order given, then one line a later tree
naming the narrow instances whose SASS differs from the first tree's, and
exits non-zero if a tree's process fails (a kernel disagreeing with its
plain version included) or there is no CUDA card.  ``--out FILE`` also
writes every tree's line with its SASS hashes to FILE.  Run the trees as
parent, change, change, parent to compare two commits on one card.
"""

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

T, B, H = 50, 4, 2048
NARROW = re.compile(r"^(lstm_seq_kernel<|lstm_seq_backward_kernel<|"
                    r"lstm_seq_backward_partials_kernel<)")


def sass_hashes(library):
    """{instance: sha256 of its SASS} of the narrow instances in a library."""
    import chip_smoke

    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(library)],
                         capture_output=True, text=True, check=True).stdout
    hashes = {}
    for part in out.split("Function : ")[1:]:
        mangled, body = part.split("\n", 1)
        name = chip_smoke.kernel_name(mangled.strip())
        if NARROW.match(name):
            body = re.sub(r"\.L_x_\d+", ".L_x", body)
            body = re.sub(r"c\[0x[24]\]\[0x[0-9a-f]+\]", "c[bank]", body)
            body = " ".join(body.split())  # cuobjdump pads columns to the library's widest
            hashes[name] = hashlib.sha256(body.encode()).hexdigest()[:16]
    return hashes


def forward_launch(fused_lstm, args):
    """The wide forward's launch alone: its C entry on outputs and a
    workspace made once, as lstm_seq_cuda calls it."""
    import torch

    gates_x, masks, h0, c0, w_hh = args
    device = gates_x.device
    w_hh_t = w_hh.t().contiguous()
    units = fused_lstm._units(device.index, H)[0]
    outs = torch.empty(T, B, H, device=device)
    hT, cT = torch.empty(B, H, device=device), torch.empty(B, H, device=device)
    stream = torch.cuda.current_stream(device)
    ws = fused_lstm.make_workspace(device, B, H)
    fn = fused_lstm._entry(True)
    ptrs = [t.data_ptr() for t in (gates_x, masks, h0, c0, w_hh_t, outs, hT, cT, ws)]

    def launch():
        err = fn(*ptrs, T, B, H, units, device.index, stream.cuda_stream)
        if err:
            raise RuntimeError(f"lstm_wide_ab: the forward's C entry returned {err}")
    return launch


def child(tree, sass_only):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke
    from robo_vln_tpu_torch.ops import _build, fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward
    from robo_vln_tpu_torch.utils.device import float32_exact

    if not torch.cuda.is_available():
        print("lstm_wide_ab: no CUDA device", file=sys.stderr)
        return 1
    log = _build.build_all(["lstm_seq"]).get("lstm_seq", "")
    fields = {"tree": tree, "card": chip_smoke.card_line()}
    # registers and spills of the wide instances, when this process built them
    fields["ptxas"] = {name: [regs, spill] for name, regs, spill in chip_smoke.ptxas_usage(log)
                       if "wide" in name}
    if not sass_only:
        lib = _build.load("lstm_seq")
        device = torch.device("cuda", 0)
        gen = torch.Generator().manual_seed(0)
        time_ms, report = chip_smoke.time_ms, chip_smoke.report_times
        with float32_exact(torch.float32):
            args = chip_smoke.lstm_inputs(gen, T, B, H, device)
            cots = chip_smoke.lstm_cotangents(gen, T, B, H, device)
            outs = fused_lstm.lstm_seq_cuda(*args)
            ref = lstm_recurrence(*args)
            torch.cuda.synchronize()
            fields["forward_max_abs_err"] = max((g - r).abs().max().item()
                                                for g, r in zip(outs, ref))
            got = fused_lstm.lstm_seq_backward_cuda(*args, outs[0], *cots)
            want = lstm_recurrence_backward(*args, outs[0], *cots)
            torch.cuda.synchronize()
            fields["backward_max_rel_err"] = max(
                (g - r).abs().max().item() / max(r.norm().item(), 1e-30)
                for g, r in zip(got, want))
            if not (fields["forward_max_abs_err"] <= chip_smoke.LSTM_TOL and
                    fields["backward_max_rel_err"] <= chip_smoke.LSTM_BACKWARD_TOL):
                print(f"lstm_wide_ab: {tree} disagrees with the plain versions: {fields}",
                      file=sys.stderr)
                return 1
            fields["units"] = fused_lstm._units(device.index, H)[0]
            fields["backward_units"] = fused_lstm._backward_units(device.index, H)[0]
            if hasattr(fused_lstm, "backward_cluster"):
                fields["backward_cluster"] = fused_lstm.backward_cluster(B, H, device)
            fields["forward_ms"] = report("forward, whole call", time_ms(
                lambda: fused_lstm.lstm_seq_cuda(*args)))
            fields["forward_launch_ms"] = report("forward, its launch alone",
                                                 time_ms(forward_launch(fused_lstm, args)))
            if hasattr(lib, "lstm_seq_wide_exchange"):
                fields["forward_exchange_ms"] = report("forward, the h exchange alone", time_ms(
                    lambda: fused_lstm.exchange_floor_cuda(T, B, H, device)))
            gates_x, masks, h0, c0, w_hh = args
            h_tilde = torch.cat([h0[None], outs[0][:-1]]) * masks[..., None]
            gates = gates_x + h_tilde @ w_hh
            fields["backward_ms"] = report("backward, whole call", time_ms(
                lambda: fused_lstm.lstm_seq_backward_cuda(*args, outs[0], *cots,
                                                          masks_grad=False)))
            fields["backward_launch_ms"] = report("backward, its launch alone", time_ms(
                lambda: fused_lstm._backward_launch(gates, masks, c0, w_hh, *cots, False)))
            if hasattr(lib, "lstm_seq_backward_partials_wide_exchange"):
                fields["backward_exchange_ms"] = report("backward, its exchange alone", time_ms(
                    lambda: fused_lstm.backward_exchange_floor_cuda(T, B, H, device)))
            lstm = torch.nn.LSTM(896, H).to(device)
            x = torch.randn(T, B, 896, generator=gen).to(device).requires_grad_()
            hc = (h0[None], c0[None])
            params = list(lstm.parameters())

            def cudnn_forward():
                with torch.enable_grad():
                    return lstm(x, hc)

            def cudnn_both():
                out, (h, c) = cudnn_forward()
                torch.autograd.grad((out, h, c), [x, *params],
                                    (cots[0], cots[1][None], cots[2][None]))

            fields["cudnn_forward_ms"] = report("cuDNN nn.LSTM(896, 2048) forward",
                                                time_ms(cudnn_forward))
            both = report("cuDNN forward and backward", time_ms(cudnn_both))
            fields["cudnn_backward_ms"] = both - fields["cudnn_forward_ms"]
        for key in [k for k in fields if k.endswith("_ms")]:
            per = T - 1 if key == "forward_exchange_ms" else T
            fields[key[:-3] + "_step_us"] = fields[key] / per * 1e3
    fields["sass"] = sass_hashes(_build.library_path("lstm_seq"))
    print(json.dumps(fields))
    return 0


def main(args):
    out_path = None
    if args[:1] == ["--out"]:
        out_path, args = args[1], args[2:]
    sass_only = args[:1] == ["--sass-only"]
    trees = args[sass_only:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    lines = []
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              os.path.abspath(tree), "--sass-only" if sass_only else "--times"],
                             capture_output=True, text=True)
        sys.stderr.write(out.stdout + out.stderr if out.returncode else out.stderr[-2000:])
        if out.returncode:
            print(f"lstm_wide_ab: {tree} failed ({out.returncode})", file=sys.stderr)
            return 1
        lines.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in lines[-1].items() if k != "sass"}))
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    by_tree = {}
    for line in lines:
        for key, value in line.items():
            if isinstance(value, float):
                by_tree.setdefault(line["tree"], {}).setdefault(key, []).append(value)
    for tree, values in by_tree.items():
        print(json.dumps({"median_of": tree, **{k: statistics.median(v)
                                                for k, v in values.items()}}))
    first = lines[0]["sass"]
    for line in lines[1:]:
        other = line["sass"]
        differ = sorted(n for n in set(first) | set(other) if first.get(n) != other.get(n))
        print(json.dumps({"sass_of": [lines[0]["tree"], line["tree"]],
                          "instances": len(set(first) | set(other)), "differ": differ}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], sys.argv[3] == "--sass-only"))
    sys.exit(main(sys.argv[1:]))
