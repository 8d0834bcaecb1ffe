#!/usr/bin/env python3
"""Time the bf16 attention kernel of several checkouts of the repo on one
CUDA card, in turns, one process each.

    python3 scripts/attention_ab.py TREE [TREE ...]

Each TREE is the root of a checkout: this one, or another commit unpacked
with ``git archive`` into a directory that .gitignore lists.  A tree's
process imports that tree's own ``robo_vln_tpu_torch`` and
``chip_smoke.time_attention``, builds its attention kernel into the tree's
``build/kernels/``, and times one bf16 call at N=200, Lq=200, h=4 at the
two shapes of chip_smoke.py's phase 3c, with its inputs rotated out of L2:
S=144, d=64 and S=200, d=128.  Prints one JSON line a tree, in the order
given ({"tree": ..., "card": ..., the time_attention fields}), and exits
non-zero if a tree's process fails or there is no CUDA card.  Run the
trees as parent, change, change, parent to compare two commits on one
card.
"""

import json
import os
import subprocess
import sys

SHAPES = (("bf16_s144", 144, 64, "the depth attention of a 384 px frame"),
          ("bf16_s200_d128", 200, 128, "self-attention over 200 tokens, d_model 512"))


def child(tree):
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
    for prefix, S, d, what in SHAPES:
        fields.update(chip_smoke.time_attention(gen, device, prefix, 200, 200, S, 4, d,
                                                torch.bfloat16, what))
    print(json.dumps(fields))
    return 0


def main(trees):
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              os.path.abspath(tree)], capture_output=True, text=True)
        sys.stderr.write(out.stdout + out.stderr if out.returncode else "")
        if out.returncode:
            print(f"attention_ab: {tree} failed ({out.returncode})", file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
