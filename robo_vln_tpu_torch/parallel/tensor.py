"""Tensor parallelism over the mesh's "model" axis: the collectives that
GSPMD places around the JAX package's ``shard_params`` layout, placed by
hand (parallel/mesh.param_shardings names the layout).

Four autograd Functions over a model group (parallel/mesh.AxisGroup), one
for each conjugate pair:

* :func:`copy_to`: identity forward, the gradient summed over the group;
* :func:`reduce_from`: the sum over the group forward (in float32), the
  gradient as it comes;
* :func:`gather_from`: the group's slices concatenated forward, this rank's
  slice of the gradient;
* :func:`split_to`: this rank's slice forward, the group's gradients
  concatenated.

Out of them, the split forms of the modules whose parameters the layout
splits, which :func:`shard_modules` swaps in place (the module's class
changes; its state_dict keys stay the reference's names, with the slices'
shapes; the models' ``linear`` helper hands a split Linear its input,
models/transformer.linear, and no other model code changes):

* :class:`ColumnParallelLinear` (weight split on its output rows): copy,
  the local product, gather, then the whole bias;
* :class:`RowParallelLinear` (split on its input columns): split, the
  local product, the partial sums reduced in float32, then the bias;
* :class:`VocabParallelEmbedding` (split on the vocabulary): the rows this
  rank holds looked up, the others zero, then reduced;
* :class:`FeatureParallelEmbedding` (split on the features): the lookup of
  this rank's features, then gathered;
* any other module (the LSTM, whose kernel needs all of W_hh resident; a
  1x1 Conv1d; a table the model reads as a tensor): its split parameters,
  read as attributes, give the whole tensor gathered over the group, the
  gradient sliced back (:class:`TensorParallel`, the weight gather).  Every
  split form reads so too, so any use the model makes of ``.weight`` stays
  right.

Both Linears take their operands rounded to the compute dtype and multiply
them in float32, through the gather or the reduce, the bias added in
float32: in bfloat16 the output and each gradient are rounded once, after
the sum over the group, as one process's bfloat16 product (float32
accumulation, the bias inside) rounds them.

Each sharded module returns its whole output to every rank of the group,
so every kernel downstream sees the operands it sees in one process, as
GSPMD gives a ``pallas_call`` it cannot partition its whole operands.  The
model's ranks must run the same modules in the same order, forward and
backward (a recompute under ``torch.utils.checkpoint`` included), which the
one program they all run does.

:func:`whole_copy`, :func:`whole_state_dict` and
:func:`whole_optimizer_state` gather (every rank of the group takes part);
:func:`local_state_dict`, :func:`local_optimizer_state` and
:func:`shard_optimizer` keep this rank's slices of whole tensors.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    k = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * k, k)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in float32, as a new tensor."""
    return group.all_reduce(x.to(torch.float32, copy=True))


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group).to(g.dtype), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; its gradient summed over ``group`` (in float32)."""
    return _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in float32; the gradient as it comes."""
    return _Reduce.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order; the
    gradient's slice of this rank."""
    return _Gather.apply(x, dim % x.dim(), group)


def split_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``; the gradient gathered."""
    return _Split.apply(x, dim % x.dim(), group)


class TensorParallel:
    """What every split module shares: ``_tp_dims`` (the split parameters'
    names and dims), ``_tp_group`` (the model group) and ``_tp_base`` (the
    class it had).  A split parameter read as an attribute is the whole
    tensor, gathered; :meth:`local` is this rank's slice."""

    def __getattr__(self, name):
        dims = self.__dict__.get("_tp_dims")
        if dims is not None and name in dims:
            return gather_from(self._parameters[name], dims[name], self._tp_group)
        return super().__getattr__(name)

    def local(self, name: str) -> nn.Parameter:
        return self._parameters[name]


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, held in float32 (its gradient rounded to
    ``dtype`` once, after any sum over the group)."""
    return x.to(dtype).float()


class ColumnParallelLinear(TensorParallel, nn.Linear):
    """A Linear whose weight rows (its outputs) are split."""

    def split_product(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        group = self._tp_group
        y = gather_from(F.linear(copy_to(_operand(x, dtype), group),
                                 _operand(self.local("weight"), dtype)), -1, group)
        if self.bias is not None:
            y = y + _operand(self.bias, dtype)
        return y.to(dtype)

    def forward(self, x):
        return self.split_product(x, self.local("weight").dtype)


class RowParallelLinear(TensorParallel, nn.Linear):
    """A Linear whose weight columns (its inputs) are split."""

    def split_product(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        group = self._tp_group
        y = reduce_from(F.linear(_operand(split_to(x, -1, group), dtype),
                                 _operand(self.local("weight"), dtype)), group)
        if self.bias is not None:
            y = y + _operand(self.bias, dtype)
        return y.to(dtype)

    def forward(self, x):
        return self.split_product(x, self.local("weight").dtype)


class VocabParallelEmbedding(TensorParallel, nn.Embedding):
    """An Embedding whose table rows (its vocabulary) are split."""

    def forward(self, ids):
        w = self.local("weight")
        local = ids - self._tp_group.rank * w.shape[0]
        outside = (local < 0) | (local >= w.shape[0])
        rows = F.embedding(local.masked_fill(outside, 0), w)
        return reduce_from(rows.masked_fill(outside[..., None], 0.0), self._tp_group).to(w.dtype)


class FeatureParallelEmbedding(TensorParallel, nn.Embedding):
    """An Embedding whose table columns (its features) are split."""

    def forward(self, ids):
        return gather_from(F.embedding(ids, self.local("weight"), self.padding_idx), -1,
                           self._tp_group)


_GATHERED: Dict[type, type] = {}


def _split_class(module: nn.Module, dims: Dict[str, int]) -> type:
    cls = type(module)
    if set(dims) == {"weight"} and cls is nn.Linear:
        return ColumnParallelLinear if dims["weight"] == 0 else RowParallelLinear
    if set(dims) == {"weight"} and cls is nn.Embedding and module.max_norm is None:
        if dims["weight"] == 1:
            return FeatureParallelEmbedding
        if module.padding_idx is None:
            return VocabParallelEmbedding
    if cls not in _GATHERED:
        _GATHERED[cls] = type(f"WeightGathered{cls.__name__}", (TensorParallel, cls),
                              {"__module__": __name__})
    return _GATHERED[cls]


@torch.no_grad()
def shard_modules(module: nn.Module, plan: Dict[str, int], mesh) -> None:
    """Keep this rank of ``mesh.model_group``'s slice of each parameter
    ``plan`` names (state_dict name -> dim, or None for whole), in place:
    the Parameter objects stay (an optimizer built on them holds the
    slices), and each owning module becomes its split form."""
    group = mesh.model_group
    owners = dict(module.named_modules())
    by_owner: Dict[str, Dict[str, int]] = {}
    for qualified, dim in plan.items():
        if dim is not None:
            owner, _, name = qualified.rpartition(".")
            by_owner.setdefault(owner, {})[name] = dim
    for owner, dims in by_owner.items():
        m = owners[owner]
        if isinstance(m, TensorParallel):
            raise ValueError(f"{owner or type(m).__name__} is split already")
        for name, dim in dims.items():
            p = m._parameters[name]
            p.data = _slice(p.data, dim, group).clone()
        base = type(m)
        m.__class__ = _split_class(m, dims)
        m._tp_base, m._tp_dims, m._tp_group = base, dict(dims), group


def split_layout(module: nn.Module) -> Dict[str, Tuple[int, object]]:
    """{state_dict name: (dim, model group)} of ``module``'s split
    parameters, in module order (the same on every rank)."""
    out = {}
    for prefix, m in module.named_modules():
        for name, dim in m.__dict__.get("_tp_dims", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = (dim, m._tp_group)
    return out


@torch.no_grad()
def whole_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` whose split parameters are whole again, in the
    modules it was built of (every rank of each model group takes part):
    what rank 0's own work (collection, featurizing) runs.  The copy holds
    no gradients."""
    whole = copy.deepcopy(module)
    for m in whole.modules():
        dims = m.__dict__.get("_tp_dims")
        if dims is None:
            continue
        for name, dim in dims.items():
            p = m._parameters[name]
            p.data = m._tp_group.all_gather(p.data, dim)
        m.__class__ = m._tp_base
        for attr in ("_tp_base", "_tp_dims", "_tp_group"):
            del m.__dict__[attr]
    for p in whole.parameters():
        p.grad = None
    return whole


@torch.no_grad()
def whole_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with each split tensor gathered whole."""
    state = module.state_dict()
    for key, (dim, group) in split_layout(module).items():
        state[key] = group.all_gather(state[key], dim)
    return state


def local_state_dict(module: nn.Module, state: Dict[str, torch.Tensor]) -> Dict:
    """A whole ``state`` with this rank's slice of each tensor ``module``
    splits, to load into it."""
    out = dict(state)
    for key, (dim, group) in split_layout(module).items():
        if key in out:
            out[key] = _slice(out[key], dim, group)
    return out


def _moments(entry: Dict) -> List[str]:
    """The keys of an optimizer's per-parameter state shaped as the
    parameter (Adam's moments; not its step count)."""
    return [k for k, v in entry.items() if torch.is_tensor(v) and v.dim() > 0]


@torch.no_grad()
def whole_optimizer_state(module: nn.Module, optimizer_state: Dict, names: List[str]) -> Dict:
    """An optimizer's ``state_dict()`` (``names``: its parameters' names in
    index order) with the moments of each split parameter gathered whole,
    in index order (the same on every rank)."""
    layout = split_layout(module)
    state = dict(optimizer_state["state"])
    for index in sorted(state):
        if names[index] in layout:
            dim, group = layout[names[index]]
            entry = dict(state[index])
            for k in _moments(entry):
                entry[k] = group.all_gather(entry[k], dim)
            state[index] = entry
    return {**optimizer_state, "state": state}


def local_optimizer_state(module: nn.Module, optimizer_state: Dict, names: List[str]) -> Dict:
    """A whole optimizer ``state_dict`` with this rank's slice of each split
    parameter's moments."""
    layout = split_layout(module)
    state = {}
    for index, entry in optimizer_state["state"].items():
        if names[index] in layout:
            dim, group = layout[names[index]]
            entry = {k: _slice(v, dim, group).clone() if k in _moments(entry) else v
                     for k, v in entry.items()}
        state[index] = entry
    return {**optimizer_state, "state": state}


@torch.no_grad()
def shard_optimizer(optimizer: torch.optim.Optimizer, module: nn.Module) -> None:
    """After :func:`shard_modules`: this rank's slice of the moments an
    optimizer built on the whole parameters already holds (a resumed
    run's), in place."""
    split = split_layout(module)
    layout = {id(p): split[name] for name, p in module.named_parameters() if name in split}
    for p, entry in optimizer.state.items():
        if id(p) in layout:
            dim, group = layout[id(p)]
            for k in _moments(entry):
                if entry[k].shape != p.shape:
                    entry[k] = _slice(entry[k], dim, group).clone()
