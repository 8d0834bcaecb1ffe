"""Cells of BENCHMARK.json cut to a size a CPU test can hold: every width
of the configuration shrunk, the mixes' batches, windows and instructions
short, on the CPU (the port's wrappers run their plain versions there), and
the CPU put in the card's place (``CpuCard``)."""

import gc
import sys
import time
import types

from hcmbench import harness

TINY = {
    "MODEL.DEPTH_ENCODER.blocks": [1, 1, 1, 1], "MODEL.RGB_ENCODER.blocks": [1, 1, 1, 1],
    "MODEL.STATE_ENCODER.hidden_size": 32, "MODEL.RGB_ENCODER.output_size": 16,
    "MODEL.DEPTH_ENCODER.output_size": 8,
    "MODEL.INSTRUCTION_ENCODER.vocab_size": 60, "MODEL.INSTRUCTION_ENCODER.hidden_size": 16,
    **{f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}": 32 for s in ("RGB", "DEPTH")
       for d in ("WIDTH", "HEIGHT")},
}
TINY_HCM = {
    "MODEL.BERT.num_layers": 1, "MODEL.BERT.hidden_size": 16, "MODEL.BERT.num_heads": 2,
    "MODEL.BERT.intermediate_size": 32, "MODEL.BERT.vocab_size": 60,
    "MODEL.VISUAL_LING_ATTN.ins_in_features": 16, "MODEL.VISUAL_LING_ATTN.d_model": 16,
    "MODEL.VISUAL_LING_ATTN.d_ff": 32, "MODEL.VISUAL_LING_ATTN.h": 2,
}
TINY_MIX = {"train": dict(batch=2, window=4, instruction_len=6, min_instruction_len=3, pool=4,
                          warmup_steps=1, trace_steps=2, trace_warmup=1),
            "eval_ondevice": dict(batch=3, max_steps=24, instruction_len=6, warmup_batches=1,
                                  pool_batches=3,
                                  check_batches=2, trace_batches=1)}


class CpuCard(harness.Card):
    """The CPU in the card's place, for rehearsals: the host's clock for the
    step stamps, no memory peak, no profile."""

    device = "cpu"
    traces = False

    def sync(self, device=None):
        pass

    def stamp(self):
        return time.perf_counter()

    def elapsed_ms(self, a, b):
        return (b - a) * 1e3

    def peak_bytes(self, device=None):
        return 0

    def release(self):
        gc.collect()

    def describe(self, count, peak_bytes):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}


def tiny_cell(name, precision="bfloat16", seed=2**31 + 5, seconds=0.3, **mix):
    return shrink(harness.load_cell(name), precision, seed, seconds, **mix)


def shrink(cell, precision="bfloat16", seed=2**31 + 5, seconds=0.3, **mix):
    """``cell`` cut to the tiny sizes, in ``precision``."""
    opts = cell.config["options"]
    opts.update(TINY)
    if cell.config["family"] == "hcm":
        opts.update(TINY_HCM)
    opts["TPU.PRECISION"] = precision
    cell.mix.update(TINY_MIX[cell.mix["driver"]])
    cell.mix.update(mix)
    cell.seed, cell.seconds = seed, seconds
    return cell


def rank_loading_jax(rank, device, cell, t0, out_dir, card):
    """A rank of the spawned train step whose process loads a module named
    ``jax`` (an empty stand-in) before its run: the last rank's, so that
    the guard has to read a rank other than the one that reports."""
    from hcmbench.drivers import train

    if rank == cell.mix["ranks"] - 1:
        sys.modules["jax"] = types.ModuleType("jax")
    train._spawned_rank(rank, device, cell, t0, out_dir, card)
