"""The rank side of tests/test_torch_multicard.py: the setup that
scripts/multicard_smoke.py's phase A (step_rank) runs on the tiny HCM.  It
imports the port and torch only (no JAX), so that a rank starts in a few
seconds.

:class:`TinySetup` hands each rank copies of a case's float32 policies (the
JAX package's variables, tests/test_torch_mesh.port_reference) and of the
same weights in bfloat16 compute, the case's global windows (B=4 whatever
the grid, so that one JAX reference holds every grid), the tests' lr and
weight decay, and splits every kernel of at least 256 elements (the JAX
dryrun's size, which the tiny kernels reach).
"""

import copy

import torch

from robo_vln_tpu_torch.models import make_shared_trunk_fn
from robo_vln_tpu_torch.training import optimizers, steps
from tests.torch_mesh_ranks import LR, WD, _tensors


class TinySetup:
    min_size = 256
    lr = LR
    bf16_steps = 2

    def __init__(self, modules, bf16_modules, windows):
        self.modules = {torch.float32: modules, torch.bfloat16: bf16_modules}
        self._windows = windows

    def policies(self, dtype, device):
        return tuple(copy.deepcopy(self.modules[dtype][level]).to(device)
                     for level in ("high", "low"))

    def optimizers(self, high, low):
        return steps.HierTrainState(steps.TrainState(optimizers.adamw(high, WD), 0),
                                    steps.TrainState(optimizers.adam(low, WD), 0))

    def steps(self, high, low, mesh):
        trunk_fn = make_shared_trunk_fn(high)
        return (steps.make_hier_train_step(high, low, trunk_fn=trunk_fn, mesh=mesh),
                steps.make_hier_val_step(high, low, trunk_fn=trunk_fn, mesh=mesh))

    def windows(self, data, device):
        return [{k: v.to(device) for k, v in _tensors(w).items()} for w in self._windows]
