"""One window of the full HCM train step over a mesh of n ranks, on tiny
shapes (counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m robo_vln_tpu_torch.parallel.dryrun 4

n ranks, spawned (parallel/mesh.spawn): NCCL over n cards, which must be
visible where there is a card, gloo on the CPU where there is none (or as
the caller asks: gloo ranks on one card, or the CPU).  The tiny sizes are
``__graft_entry__._hcm_setup(tiny=True)``'s (64 px frames, BERT 2×32, an
LSTM of 32, a 16-token instruction, T=4), one episode a rank, random
weights from seed 0 with synced trunks, broadcast from rank 0: the shared
trunk pass, both policies, the losses over the global batch, the
gradients' all-reduce and both optimizers' steps.  Rank 0 prints the
global metrics; every one must be finite, and the ranks' weights must
agree after the step.

At an even n of at least 4 a second phase runs, as the JAX dryrun's: the
same global batch on the ``[n/2, 2]`` grid, both policies' kernels of at
least 256 elements split over the "model" axis (mesh.shard_params); its
metrics must be finite, the ranks of each data group (one model rank) must
hold equal slices and the ranks of each model group equal whole tensors
after the step, and rank 0 prints the split tensors' count.
"""

from __future__ import annotations

import sys

import torch

from . import tensor

T, L, PX = 4, 16, 64
TINY_MODEL = {
    "BERT.num_layers": 2, "BERT.hidden_size": 32, "BERT.num_heads": 2,
    "BERT.intermediate_size": 64, "BERT.vocab_size": 64,
    "VISUAL_LING_ATTN.ins_in_features": 32, "VISUAL_LING_ATTN.d_model": 16,
    "VISUAL_LING_ATTN.d_ff": 32, "VISUAL_LING_ATTN.h": 2,
    "STATE_ENCODER.hidden_size": 32, "RGB_ENCODER.output_size": 16,
    "DEPTH_ENCODER.output_size": 8, "INSTRUCTION_ENCODER.vocab_size": 64,
    "INSTRUCTION_ENCODER.is_bert": True,
    "INSTRUCTION_ENCODER.use_pretrained_embeddings": False,
}


def _global_batch(n: int):
    """n episodes of T steps, the dryrun's inputs, from seed 1."""
    gen = torch.Generator().manual_seed(1)
    masks = torch.ones(n, T)
    masks[:, 0] = 0.0
    return {
        "rgb": torch.randint(0, 255, (n, T, PX, PX, 3), generator=gen, dtype=torch.uint8),
        "depth": torch.rand(n, T, PX, PX, 1, generator=gen).half(),
        "instruction": torch.randint(1, 60, (n, L), generator=gen, dtype=torch.int32),
        "vln_oracle_action_sensor": torch.randint(1, 5, (n, T), generator=gen).float(),
        "prev_actions": torch.zeros(n, T, 2),
        "corrected_actions": torch.rand(n, T, 2, generator=gen),
        "oracle_stop": (torch.rand(n, T, 1, generator=gen) > 0.7).float(),
        "not_done_masks": masks,
        "valid_mask": torch.ones(n, T),
    }


def _flat_weights(*modules) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for m in modules for p in m.parameters()])


def _agree(weights: torch.Tensor, group) -> bool:
    """Whether ``weights`` equal the first rank's of ``group``."""
    ref = weights.clone()
    group.broadcast(ref)
    return torch.equal(weights, ref)


def _dryrun_phase(rank: int, device, n: int, model: int):
    """(metrics, mesh, split tensors by level) of one window on the
    ``[n / model, model]`` grid."""
    from ..config import get_config
    from ..models import build_hierarchical_policies, make_shared_trunk_fn, sync_frozen_trunks
    from ..training import HierTrainState, TrainState, adam, adamw, make_hier_train_step
    from .mesh import DataMesh, shard_params

    opts = [x for k, v in TINY_MODEL.items() for x in (f"MODEL.{k}", v)]
    opts += [x for s in ("RGB", "DEPTH") for d in ("WIDTH", "HEIGHT")
             for x in (f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}", PX)]
    cfg = get_config(opts=opts + ["MODEL.DEPTH_ENCODER.input_size", PX])
    high, low = build_hierarchical_policies(cfg.MODEL, compute_dtype=torch.float32,
                                            generator=torch.Generator().manual_seed(0))
    sync_frozen_trunks(high, low)
    high, low = high.to(device), low.to(device)
    mesh = DataMesh(device, size=n // model, model=model)
    mesh.broadcast(high, low)
    split = {}
    if model > 1:
        for level, policy in (("high", high), ("low", low)):
            plan = shard_params(policy, mesh, min_size=256)
            split[level] = sum(dim is not None for dim in plan.values())
    state = HierTrainState(TrainState(adamw(high, 1e-3), 0), TrainState(adam(low, 1e-3), 0))
    step = make_hier_train_step(high, low, trunk_fn=make_shared_trunk_fn(high), mesh=mesh)
    batch = {k: v.to(device) for k, v in mesh.shard(_global_batch(n)).items()}
    b = n // mesh.size
    _, _, _, metrics = step(state, high.initial_hidden(b, device), low.initial_hidden(b, device),
                            batch, 1e-4, 1e-4)
    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if not torch.isfinite(torch.tensor(v))]
    if bad:
        raise RuntimeError(f"dryrun_multichip({n}) on {mesh.size} x {model}: non-finite "
                           f"metrics {bad}")
    weights = _flat_weights(high, low)
    if not _agree(weights, mesh.data_group):
        raise RuntimeError(f"dryrun_multichip({n}): rank {rank}'s weights differ from its "
                           "data group's first rank's")
    if model > 1 and not _agree(_flat_weights(tensor.whole_copy(high), tensor.whole_copy(low)),
                                mesh.model_group):
        raise RuntimeError(f"dryrun_multichip({n}): rank {rank}'s whole weights differ from "
                           "its model group's first rank's")
    return values, mesh, split


def _dryrun_rank(rank: int, device, n: int) -> None:
    import torch.distributed as dist

    values, _, _ = _dryrun_phase(rank, device, n, 1)
    if rank == 0:
        print(f"dryrun_multichip({n}) ok ({dist.get_backend()}): "
              + ", ".join(f"{k}={v:.4f}" for k, v in values.items()), flush=True)
    if n >= 4 and n % 2 == 0:
        values, mesh, split = _dryrun_phase(rank, device, n, 2)
        if rank == 0:
            print(f"dryrun_multichip({n}) dp x tp ({mesh.size} x {mesh.model_size}) ok: "
                  f"{sum(split.values())} tensor-sharded kernels (high {split['high']}, "
                  f"low {split['low']}), "
                  + ", ".join(f"{k}={v:.4f}" for k, v in values.items()), flush=True)


def dryrun_multichip(n: int, timeout_s: float = 900.0, device=None,
                     backend=None) -> None:
    """One window of the HCM train step over n ranks, and at an even n of
    at least 4 the ``[n/2, 2]`` phase (see the module's docstring); raises
    when a rank fails or is still running after ``timeout_s``.  ``device``
    and ``backend`` as parallel/mesh.spawn takes them (``"cuda:0"`` and
    ``"gloo"``: every rank on one card); by default a rank a card, which
    needs n visible cards, and the CPU only where there is no card."""
    from .mesh import spawn

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
        if device == "cuda" and torch.cuda.device_count() < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) puts a rank on each card and "
                f"{torch.cuda.device_count()} CUDA devices are visible: pass "
                "device='cuda:0', backend='gloo' for every rank on one card, or "
                "device='cpu'")
    spawn(_dryrun_rank, n, device, n, timeout_s=timeout_s, backend=backend)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
