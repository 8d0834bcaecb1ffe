#!/usr/bin/env python3
"""Time the attention kernels of several checkouts of the repo on one CUDA
card, in turns, one process each, and compare their aligned instances'
machine code.

    python3 scripts/attention_ab.py [--out FILE] [--only PREFIX,...] [--sass-only] TREE [TREE ...]

Each TREE is the root of a checkout: this one, or another commit unpacked
with ``git archive`` into a directory that .gitignore lists.  A tree's
process imports that tree's own ``robo_vln_tpu_torch`` and
``chip_smoke.time_attention``, builds its attention kernel into the tree's
``build/kernels/``, and times one call of each of SHAPES at N=200, Lq=200,
with its inputs rotated out of L2: the float32 key blocks ((a) S=144, d=64;
(b) S=200, d=128; (c) S=500, d=60, all h=4; (e) S=200, d=256, h=2; phase
14's d=256, h=1 at S=16 and 64), the bf16 key blocks (S=144, d=64 and
S=200, d=128), the wide kernels (float32 d=260, h=2; bf16 d=256 and 260,
h=2, and phase 14's d=256, h=1 at S=16 and 64) and the bf16 fill instance
(d=72 beside the aligned d=80; d=64 one element off 16 bytes beside the
aligned d=64).  It also hashes the SASS (``cuobjdump -sass``) of every
instance of the kernels that the HCM's calls take (the bf16 kernels'
aligned instances and the float32 kernel that holds a head's keys whole,
not its key-block kernel; branch labels,
which cuobjdump numbers across the whole library, and offsets into its
constant banks 2 and 4, which other kernels shift, and the padding of its
columns are left out; ``--sass-only`` skips the timings).  Prints
one JSON line a tree, in the order given ({"tree": ..., "card": ..., the
time_attention fields}), then one line a later tree naming the instances
whose SASS differs from the first tree's, and exits non-zero if a tree's
process fails or there is no CUDA card.  ``--out FILE`` also writes every
tree's line with its SASS hashes ("sass": {instance: hash}) to FILE;
``--only`` times only the SHAPES of the prefixes given.
Run the trees as parent, change, change, parent to compare two commits on
one card.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

# prefix, S, d, heads, dtype, offset (elements off 16 bytes), what
SHAPES = (("f32_s144", 144, 64, 4, "f32", 0, "(a) the float32 depth attention of a 384 px frame"),
          ("f32_s200_d128", 200, 128, 4, "f32", 0, "(b) float32 self-attention over 200 tokens"),
          ("f32_s500_d60", 500, 60, 4, "f32", 0, "(c) float32 d = 60 zero-filled to 64"),
          ("f32_s200_d256_h2", 200, 256, 2, "f32", 0, "(e) float32 d_model 512 over 2 heads"),
          ("f32_s16_d256", 16, 256, 1, "f32", 0, "phase 14's float32 window, rgb"),
          ("f32_s64_d256", 64, 256, 1, "f32", 0, "phase 14's float32 window, depth"),
          ("bf16_s144", 144, 64, 4, "bf16", 0, "the depth attention of a 384 px frame"),
          ("bf16_s200_d128", 200, 128, 4, "bf16", 0, "self-attention over 200 tokens, d_model 512"),
          ("wide_f32_d260", 200, 260, 2, "f32", 0, "the wide kernel in float32"),
          ("wide_bf16_d256_h2", 200, 256, 2, "bf16", 0, "the wide kernel in bf16"),
          ("wide_bf16_s16", 16, 256, 1, "bf16", 0, "phase 14's window, rgb"),
          ("wide_bf16_s64", 64, 256, 1, "bf16", 0, "phase 14's window, depth"),
          ("wide_bf16_d260", 200, 260, 2, "bf16", 0, "the wide kernel's narrow instance"),
          ("fill_d72", 64, 72, 4, "bf16", 0, "(f) the fill instance, zero-filled to 80"),
          ("aligned_d80", 64, 80, 4, "bf16", 0, "the aligned instance (f) fills to"),
          ("fill_d64_off1", 64, 64, 4, "bf16", 1, "(g) the fill instance, one element off"),
          ("aligned_d64", 64, 64, 4, "bf16", 0, "the window's depth call, aligned"))

# the instances the HCM's calls take, whose SASS a change to the others must leave alone
HCM_INSTANCES = re.compile(
    r"^(cross_modal_attn_bf16_kernel<|cross_modal_attn_f32tc_kernel<|"
    r"cross_modal_attn_bf16_blocks_kernel<\d+,\d,0>)")


def sass_hashes(library):
    """{instance: sha256 of its SASS} of the HCM instances in a library."""
    import chip_smoke

    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(library)],
                         capture_output=True, text=True, check=True).stdout
    hashes = {}
    for part in out.split("Function : ")[1:]:
        mangled, body = part.split("\n", 1)
        name = chip_smoke.kernel_name(mangled.strip())
        if HCM_INSTANCES.match(name):
            body = re.sub(r"\.L_x_\d+", ".L_x", body)
            body = re.sub(r"c\[0x[24]\]\[0x[0-9a-f]+\]", "c[bank]", body)
            body = " ".join(body.split())  # cuobjdump pads columns to the library's widest
            hashes[name] = hashlib.sha256(body.encode()).hexdigest()[:16]
    return hashes


def child(tree, sass_only, only=None):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke
    from robo_vln_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all(["cross_modal_attn"])
    gen = torch.Generator().manual_seed(0)
    device = torch.device("cuda", 0)
    fields = {"tree": tree, "card": chip_smoke.card_line()}
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for prefix, S, d, heads, dtype, offset, what in () if sass_only else SHAPES:
        if only and prefix not in only:
            continue
        fields.update(chip_smoke.time_attention(gen, device, prefix, 200, 200, S, heads, d,
                                                dtypes[dtype], what, offset=offset))
    fields["sass"] = sass_hashes(_build.library_path("cross_modal_attn"))
    print(json.dumps(fields))
    return 0


def main(args):
    out_path = only = None
    if args[:1] == ["--out"]:
        out_path, args = args[1], args[2:]
    if args[:1] == ["--only"]:
        only, args = args[1], args[2:]
        if not set(only.split(",")) <= {shape[0] for shape in SHAPES}:
            print(f"attention_ab: --only takes prefixes of SHAPES, got {only}", file=sys.stderr)
            return 2
    sass_only = args[:1] == ["--sass-only"]
    trees = args[sass_only:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    lines = []
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              os.path.abspath(tree), "--sass-only" if sass_only else "--times",
                              *([only] if only else [])],
                             capture_output=True, text=True)
        sys.stderr.write(out.stdout + out.stderr if out.returncode else "")
        if out.returncode:
            print(f"attention_ab: {tree} failed ({out.returncode})", file=sys.stderr)
            return 1
        lines.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in lines[-1].items() if k != "sass"}))
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    first = lines[0]["sass"]
    for line in lines[1:]:
        other = line["sass"]
        differ = sorted(n for n in set(first) | set(other) if first.get(n) != other.get(n))
        print(json.dumps({"sass_of": [lines[0]["tree"], line["tree"]],
                          "instances": len(set(first) | set(other)), "differ": differ}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], sys.argv[3] == "--sass-only",
                       set(sys.argv[4].split(",")) if sys.argv[4:] else None))
    sys.exit(main(sys.argv[1:]))
