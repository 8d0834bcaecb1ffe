"""The rank side of tests/test_torch_tensor_parallel.py: one process a rank
of a gloo group on the CPU (parallel/mesh.spawn), on a ``[d, m]`` grid.  It
imports the port and torch only (no JAX), so that a rank starts in a few
seconds.

:func:`module_errors` holds each split module (the column and row Linear,
both Embeddings, the weight-gathered LSTM, a Conv1d read as a tensor)
against the whole module on the same inputs: the forward and every
gradient, as the largest absolute error.

:func:`run_case` steps a case of tests/torch_mesh_ranks.py (the tiny HCM or
the flat Seq2Seq with the progress monitor) with both policies split at
``min_size``: each window's metrics, its rows of the hidden states, every
trainable gradient and parameter gathered whole, and this rank's own
tensors (the slices of the split ones, the whole replicated ones), then the
val step on the first window.

:func:`train_rank` is a rank of a trainer run on the grid, its tiny
kernels split.
"""

import copy

import torch
from torch import nn

from robo_vln_tpu_torch.models import make_shared_trunk_fn
from robo_vln_tpu_torch.models.rnn_state_encoder import RNNStateEncoder
from robo_vln_tpu_torch.models.transformer import linear
from robo_vln_tpu_torch.parallel import tensor
from robo_vln_tpu_torch.parallel.mesh import DataMesh, param_shardings, shard_params
from robo_vln_tpu_torch.training import optimizers, steps
from tests.torch_mesh_ranks import LR, WD, _tensors

MODULES = {
    "column_linear": lambda: nn.Linear(16, 32),
    "row_linear": lambda: nn.Linear(32, 16),
    "vocab_embedding": lambda: nn.Embedding(20, 8),
    "feature_embedding": lambda: nn.Embedding(10, 16),
    "lstm": lambda: RNNStateEncoder(12, 16, "LSTM"),
    "conv1d": lambda: nn.Conv1d(24, 8, 1),
}
# the split form each module takes (and the weight gather for the rest)
SPLIT_FORMS = {"column_linear": "ColumnParallelLinear", "row_linear": "RowParallelLinear",
               "vocab_embedding": "VocabParallelEmbedding",
               "feature_embedding": "FeatureParallelEmbedding",
               "lstm": "WeightGathered_RNNWeights", "conv1d": "WeightGatheredConv1d"}


def _inputs(kind, gen):
    if kind in ("column_linear", "row_linear"):
        return (torch.randn(3, 5, 16 if kind == "column_linear" else 32, generator=gen),)
    if kind.endswith("embedding"):
        return (torch.randint(0, 20 if kind == "vocab_embedding" else 10, (3, 7), generator=gen),)
    if kind == "lstm":
        masks = torch.ones(6, 2)
        masks[3, 1] = 0.0
        return (torch.randn(6, 2, 12, generator=gen), torch.randn(2, 2, 16, generator=gen) * 0.1,
                masks)
    return (torch.randn(3, 9, 24, generator=gen),)


def _forward(kind, module, inputs):
    if kind in ("column_linear", "row_linear"):  # through the models' helper
        return linear(inputs[0], module, torch.float32)
    if kind == "lstm":
        out, hidden = module(*inputs)
        return torch.cat([out.reshape(-1), hidden.reshape(-1)])
    if kind == "conv1d":  # the 1x1 convolution as the HCM reads it
        return nn.functional.linear(inputs[0], module.weight[:, :, 0], module.bias)
    return module(*inputs)


def _grads(kind, module, inputs):
    """(output, {name: gradient}) of a fixed random projection of the
    output; the inputs' gradients under ``input{i}``."""
    inputs = [x.clone().requires_grad_(x.is_floating_point()) for x in inputs]
    out = _forward(kind, module, inputs)
    probe = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    (out * probe).sum().backward()
    grads = {n: p.grad for n, p in module.named_parameters()}
    grads.update({f"input{i}": x.grad for i, x in enumerate(inputs) if x.grad is not None})
    return out.detach(), grads


def module_errors(mesh):
    """{kind: (split form, {what: largest absolute error against the whole
    module})}, each split module's gradients gathered whole."""
    out = {}
    for i, kind in enumerate(MODULES):
        whole = MODULES[kind]()
        gen = torch.Generator().manual_seed(i)
        with torch.no_grad():
            for p in whole.parameters():
                p.normal_(0.0, 0.3, generator=gen)
        split = copy.deepcopy(whole)
        shard_params(split, mesh, min_size=1)
        inputs = _inputs(kind, torch.Generator().manual_seed(10 + i))
        want, want_grads = _grads(kind, whole, inputs)
        got, got_grads = _grads(kind, split, inputs)
        layout = tensor.split_layout(split)
        errors = {"forward": (got - want).abs().max().item()}
        for name, g in got_grads.items():
            if name in layout:
                dim, group = layout[name]
                g = group.all_gather(g, dim)
            errors[name] = (g - want_grads[name]).abs().max().item()
        owner = split.rnn if kind == "lstm" else split
        out[kind] = (type(owner).__name__, errors, sorted(layout))
    return out


def _named(modules, fn):
    return {f"{level}.{n}": fn(p) for level, m in modules.items()
            for mask in (optimizers.trainable_mask(m),)
            for n, p in m.named_parameters() if mask[n] and fn(p) is not None}


def run_case(case, mesh, min_size):
    """tests/torch_mesh_ranks.run_case's steps with both policies split at
    ``min_size`` after the broadcast, as the trainers split them."""
    modules = copy.deepcopy(case["modules"])
    mesh.broadcast(*modules.values())
    plans = {level: shard_params(m, mesh, min_size) for level, m in modules.items()}
    hier = case["kind"] == "hier"
    remat = case.get("remat", False)
    if hier:
        high, low = modules["high"], modules["low"]
        trunk_fn = make_shared_trunk_fn(high)
        state = steps.HierTrainState(steps.TrainState(optimizers.adamw(high, WD), 0),
                                     steps.TrainState(optimizers.adam(low, WD), 0))
        train = steps.make_hier_train_step(high, low, trunk_fn=trunk_fn, mesh=mesh, remat=remat)
        val = steps.make_hier_val_step(high, low, trunk_fn=trunk_fn, mesh=mesh)
        b = case["windows"][0]["valid_mask"].shape[0] // mesh.size
        hidden = (high.initial_hidden(b), low.initial_hidden(b))
    else:
        policy = modules["policy"]
        state = steps.TrainState(optimizers.adam(policy), 0)
        train = steps.make_flat_train_step(policy, use_progress=True, remat=remat,
                                           progress_alpha=case["alpha"], mesh=mesh)
        val = steps.make_flat_val_step(policy, use_progress=True, progress_alpha=case["alpha"],
                                       mesh=mesh)
        b = case["windows"][0]["valid_mask"].shape[0] // mesh.size
        hidden = (policy.initial_hidden(b),)
    layouts = {f"{level}.{n}": v for level, m in modules.items()
               for n, v in tensor.split_layout(m).items()}

    def whole(name, t):
        if name not in layouts:
            return t.detach().clone()
        dim, group = layouts[name]
        return group.all_gather(t.detach(), dim)

    def gathered(fn):
        return {name: whole(name, t) for name, t in _named(modules, fn).items()}

    out = {"windows": [], "plans": plans}
    for window in case["windows"]:
        batch = _tensors(mesh.shard(window))
        if hier:
            state, hh, lh, metrics = train(state, *hidden, batch, LR, LR)
            hidden = (hh, lh)
        else:
            state, h, metrics = train(state, *hidden, batch, LR)
            hidden = (h,)
        out["windows"].append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "hidden": [h.clone() for h in hidden],
            "grads": gathered(lambda p: p.grad), "params": gathered(lambda p: p),
            "local": _named(modules, lambda p: p.detach().clone())})
    batch = _tensors(mesh.shard(case["windows"][0]))
    if hier:
        *val_hidden, metrics = val(high.initial_hidden(b), low.initial_hidden(b), batch)
    else:
        *val_hidden, metrics = val(policy.initial_hidden(b), batch)
    out["val"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "hidden": [h.clone() for h in val_hidden]}
    optimizers_of = ({"high": state.high.optimizer, "low": state.low.optimizer} if hier
                     else {"policy": state.optimizer})
    out["moments"] = {}
    for level, opt in optimizers_of.items():
        names = {id(p): n for n, p in modules[level].named_parameters()}
        for p, entry in opt.state.items():
            out["moments"][f"{level}.{names[id(p)]}"] = [v.clone() for v in entry.values()
                                                         if v.dim() > 0]
    return out


def rank_main(rank, device, job_path, out_dir, model, min_size):
    """parallel/mesh.spawn's target: on a grid with ``model`` ranks on the
    model axis, the split modules (on a [1, 2] grid) and every case of the
    job."""
    cases = torch.load(job_path, weights_only=False)
    mesh = DataMesh(device, model=model)
    results = {"place": (mesh.rank, mesh.model_rank)}
    if mesh.size == 1 and model == 2:
        results["modules"] = module_errors(mesh)
        results["plan_of_rule"] = {kind: param_shardings(MODULES[kind](), 2, 1)
                                   for kind in MODULES}
    for name, case in cases.items():
        results[name] = run_case(case, mesh, min_size)
    torch.save(results, f"{out_dir}/rank{rank}.pt")



def train_rank(rank, device, min_size, exp_config, opts):
    """What run_exp spawns for a rank of a ``[d, m]`` grid (run._train_rank),
    with shard_params' default ``min_size`` (JAX's 65,536, which no kernel
    of the tiny models reaches) set to ``min_size``, as the JAX dryrun
    splits its tiny model."""
    from robo_vln_tpu_torch import run
    from robo_vln_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.shard_params.__defaults__ = (min_size,)
    run._train_rank(rank, device, exp_config, opts)
