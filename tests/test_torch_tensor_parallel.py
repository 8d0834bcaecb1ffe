"""The "model" mesh axis (parallel/mesh.param_shardings and shard_params,
parallel/tensor.py's split modules, the trainers on a ``[d, m]`` grid) on
the CPU.

(a) The plan against JAX's rule: both full-width HCM policies and the
    flat CMA and Seq2Seq, built on the meta device, at a model axis of 2
    and 4 and at the default ``min_size`` and 256.  Each port state_dict is
    carried into the JAX tree by the JAX package's converters
    (robo_vln_tpu/training/checkpoint.convert_*_state_dict), each tensor
    filled (as a zero-copy numpy view) with its own id and its row index,
    so that every JAX leaf names the port tensor it came from and whether
    the converter transposed it; ``robo_vln_tpu.parallel.mesh.
    param_shardings`` on the conftest's 8-device CPU mesh must then split
    the same tensors on the same dims as the port's rule.  The spatial
    embedding tables keep their (S, 64) shape in both layouts, their
    elements permuted (the reference's scrambled view): they are compared
    by dim.  The element counts at full width are pinned.
(b) Each split module on a ``[1, 2]`` grid of gloo ranks against the whole
    module (tests/torch_tp_ranks.py): forward and every gradient within
    1e-6 in float32.
(c) The HCM's and the flat Seq2Seq-with-progress's train and val steps
    over ``[1, 2]`` and ``[2, 2]`` (two windows, dropout off, every 2-D
    kernel of at least 256 elements split), held to the JAX package's
    single-device step and to the port's one-process step at
    tests/test_torch_mesh.py's tolerances, with TPU.REMAT on too; the HCM
    in bfloat16 (the default TPU.PRECISION) held to the one-process
    bfloat16 step within bfloat16's unit roundoff; every gathered tensor
    equals across ranks, each rank's own tensors are the slices of its
    gathered ones, the ranks of a data group (one model rank) hold
    bitwise-equal slices and the ranks of a model group bitwise-equal
    whole tensors, and each Adam moment is held as the slice.
(d) Checkpoints: a ``[1, 2]`` trainer epoch, on the ranks run_exp starts
    (run._train_rank, with shard_params' default min_size set to 256 in
    them: tests/torch_tp_ranks.train_rank), writes the one-process run's
    checkpoint (keys, shapes, values within 1e-5), and resumes on
    ``[1, 2]`` and on one process to the one-process run's next; a whole
    checkpoint loads into split policies as each rank's slices.
(e) The trainers' other paths on ``[1, 2]``: featurizing (the feature
    store one process's, byte for byte), the flat trainer's epoch, and a
    DAgger collection that both trainers' split policies drive.
The refusals that a model axis used to meet are converted in
tests/test_torch_trainer.py, tests/test_torch_mesh.py and
tests/test_torch_collection.py (which also holds the expert's collection
on ``[1, 2]`` through run_exp).
"""

import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from robo_vln_tpu.parallel import mesh as jax_mesh
from robo_vln_tpu.training import checkpoint as jax_ckpt
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.models.cma import CMAPolicy
from robo_vln_tpu_torch.models.hierarchical import HighLevelPolicy, LowLevelPolicy
from robo_vln_tpu_torch.models.seq2seq import Seq2SeqPolicy
from robo_vln_tpu_torch.parallel import mesh as mesh_lib
from robo_vln_tpu_torch.run import run_exp
from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
from tests import torch_mesh_ranks, torch_tp_ranks
from tests.test_torch_mesh import (_np, _rows, check_ranks, flat_windows, hier_windows,
                                   jax_flat_reference, jax_hier_reference, port_reference)
from tests.test_torch_train_step import LR
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_trainer import tiny_opts
from tests.test_trainers import fill_buffer

PORT_CONFIGS = os.path.join(os.path.dirname(mesh_lib.__file__), "..", "config", "configs")
MIN_SIZE = 256  # the JAX dryrun's and multichip test's, so that tiny kernels split


# -- (a) the plan against JAX's rule --------------------------------------------------

def _meta_policies(family):
    """(port module, JAX converter, the converted tree's params key) of each
    policy of ``family`` at full width, on the meta device."""
    with torch.device("meta"):
        if family == "hcm":
            cfg = get_config(opts=["MODEL.INSTRUCTION_ENCODER.is_bert", True])
            return [(HighLevelPolicy(cfg.MODEL, num_actions=4),
                     jax_ckpt.convert_high_level_state_dict),
                    (LowLevelPolicy(cfg.MODEL, num_actions=2, num_sub_tasks=4),
                     jax_ckpt.convert_low_level_state_dict)]
        cfg = get_config(os.path.join(PORT_CONFIGS, f"{family}_robo.yaml"))
        if family == "cma":
            return [(CMAPolicy(cfg.MODEL, num_actions=2), jax_ckpt.convert_cma_state_dict)]
        return [(Seq2SeqPolicy(cfg.MODEL, num_actions=2, num_sub_tasks=4),
                 lambda sd: {"params": jax_ckpt.convert_seq2seq_state_dict(sd)})]


def _encoded_state_dict(module):
    """(keys, state_dict as numpy views): tensor k filled with
    ``k·2^20 + its row index``, without allocating it."""
    state = module.state_dict()
    keys = sorted(state)
    out = {}
    for k, key in enumerate(keys):
        shape = tuple(state[key].shape)
        if not shape:
            out[key] = np.float64(k << 20)
            continue
        rows = (k << 20) + np.arange(shape[0], dtype=np.float64)
        out[key] = np.broadcast_to(rows.reshape((-1,) + (1,) * (len(shape) - 1)), shape)
    return keys, out


def _jax_plan(module, convert, n_model, min_size):
    """{port state_dict name: the port dim JAX's rule splits, or None} over
    the port tensors that reach a 2-D leaf of the converted tree."""
    keys, state = _encoded_state_dict(module)
    tree = convert(state)["params"]
    mesh = jax_mesh.make_mesh([8 // n_model, n_model], ["data", "model"])
    shardings = jax.tree_util.tree_leaves(jax_mesh.param_shardings(tree, mesh, min_size))
    plan = {}
    for leaf, sharding in zip(jax.tree_util.tree_leaves(tree), shardings):
        if np.ndim(leaf) != 2:
            continue
        key = keys[int(leaf[0, 0]) >> 20]
        spec = list(sharding.spec) + [None] * 2
        dim = spec.index("model") if "model" in spec[:2] else None
        port = tuple(module.state_dict()[key].shape[:2])
        if leaf.shape == port[::-1] and port[0] != port[1]:
            transposed = True
        elif leaf.shape == port and (port[0] != port[1] or key.endswith("spatial_embeddings.weight")):
            transposed = False
        else:  # square: the row index runs along the port's dim 0
            transposed = leaf[0, 1] != leaf[0, 0]
            assert transposed != (leaf[1, 0] != leaf[0, 0]), key
        assert key not in plan, key
        plan[key] = None if dim is None else (1 - dim if transposed else dim)
    return plan


@pytest.mark.parametrize("min_size", [1 << 16, MIN_SIZE])
@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("family", ["hcm", "cma", "seq2seq"])
def test_the_plan_is_jax_rule(family, n_model, min_size):
    for module, convert in _meta_policies(family):
        port = mesh_lib.param_shardings(module, n_model, min_size)
        want = _jax_plan(module, convert, n_model, min_size)
        assert {k: port[k] for k in want} == want
        # a parameter the JAX tree lacks (none at these configs) stays whole
        assert all(port[k] is None for k in set(port) - set(want))
        assert any(d is not None for d in want.values()) or family != "hcm"


# full width, model axis 2, the default min_size: (tensors split, their
# elements, all elements) of each HCM level; the JAX tree converted from the
# port's state_dict holds the progress monitor (513 elements) that flax's
# init leaves out of the JAX policies' own trees
HCM_COUNTS = {"high": (87, 114_568_704, 144_425_701), "low": (4, 2_686_976, 32_386_180)}


def test_hcm_counts_at_full_width():
    for (module, _), level in zip(_meta_policies("hcm"), ("high", "low")):
        plan = mesh_lib.param_shardings(module, 2)
        params = dict(module.named_parameters())
        split = [n for n, d in plan.items() if d is not None]
        total = sum(p.numel() for p in params.values())
        elements = sum(params[n].numel() for n in split)
        assert (len(split), elements, total) == HCM_COUNTS[level]
        per_rank = total - elements // 2
        assert per_rank == {"high": 87_141_349, "low": 31_042_692}[level]
        # less the progress monitor, the JAX policies' own counts
        assert per_rank - 513 == {"high": 87_140_836, "low": 31_042_179}[level]
    # the conv trunks' 4-D kernels stay whole; BERT's word table splits on
    # its vocabulary, the position table on its features
    high_plan = mesh_lib.param_shardings(_meta_policies("hcm")[0][0], 2)
    assert high_plan["embedding_layer.embeddings.word_embeddings.weight"] == 0
    assert high_plan["embedding_layer.embeddings.position_embeddings.weight"] == 1
    assert high_plan["state_encoder.rnn.weight_hh_l0"] == 0
    assert not any(d is not None for k, d in high_plan.items() if ".cnn." in k
                   or "visual_encoder" in k)


# -- (b), (c): the split modules and the steps on gloo ranks ------------------------

def run_grid(job, d, m):
    out = job.parent / f"out{d}x{m}"
    out.mkdir()
    mesh_lib.spawn(torch_tp_ranks.rank_main, d * m, "cpu", str(job), str(out), m, MIN_SIZE,
                   timeout_s=600)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(d * m)]


def bf16_case(case):
    """The HCM case with its policies built in bfloat16 compute (the
    default TPU.PRECISION), the case's weights."""
    from robo_vln_tpu_torch.models import build_hierarchical_policies
    from tests.test_torch_train_step import tiny_configs

    _, mc = tiny_configs()
    mc.VISUAL_LING_ATTN.dropout = 0.0
    modules = dict(zip(("high", "low"), build_hierarchical_policies(
        mc, compute_dtype=torch.bfloat16)))
    for level, m in modules.items():
        m.load_state_dict(case["modules"][level].state_dict())
    return {**case, "modules": modules}


@pytest.fixture(scope="module")
def references():
    windows = {"hier": hier_windows(), "flat": flat_windows()}
    jax_refs = {"hier": jax_hier_reference(windows["hier"]),
                "flat": jax_flat_reference(windows["flat"])}
    cases, port_refs = {}, {}
    for kind, w in windows.items():
        case, ref = port_reference(kind, w)
        cases[kind] = {**case, "windows": w}
        cases[f"{kind}_remat"] = {**case, "windows": w, "remat": True}
        port_refs[kind] = (ref["windows"], ref["val"])
    cases["hier_bf16"] = bf16_case(cases["hier"])
    ref = torch_mesh_ranks.run_case(cases["hier_bf16"], mesh_lib.DataMesh("cpu"))
    port_refs["hier_bf16"] = (ref["windows"], ref["val"])
    return cases, jax_refs, port_refs


@pytest.fixture(scope="module")
def grids(references, tmp_path_factory):
    cases, _, _ = references
    root = tmp_path_factory.mktemp("tp")
    torch.save(cases, root / "job.pt")
    results = {(d, m): run_grid(root / "job.pt", d, m) for d, m in ((1, 2), (2, 2))}
    shutil.rmtree(root)
    return results


@pytest.mark.parametrize("kind", list(torch_tp_ranks.MODULES))
def test_each_split_module_matches_the_whole_one(grids, kind):
    for rank in grids[1, 2]:
        form, errors, split = rank["modules"][kind]
        assert form == torch_tp_ranks.SPLIT_FORMS[kind]
        assert split, kind
        for what, err in errors.items():
            assert err <= 1e-6, (kind, what, err)


def test_the_rule_picks_each_split_form(grids):
    plans = grids[1, 2][0]["plan_of_rule"]
    assert plans["column_linear"] == {"weight": 0, "bias": None}
    assert plans["row_linear"] == {"weight": 1, "bias": None}
    assert plans["vocab_embedding"] == {"weight": 0}
    assert plans["feature_embedding"] == {"weight": 1}
    assert plans["lstm"] == {"rnn.weight_ih_l0": 0, "rnn.weight_hh_l0": 0,
                             "rnn.bias_ih_l0": None, "rnn.bias_hh_l0": None}
    assert plans["conv1d"] == {"weight": 1, "bias": None}


def _by_model_rank(results, m):
    """The ranks of each model rank, in data-rank order."""
    return [results[j::m] for j in range(m)]


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
@pytest.mark.parametrize("case", ["hier", "hier_remat", "flat", "flat_remat"])
def test_split_steps_match_jax_single_device(references, grids, case, grid):
    _, jax_refs, _ = references
    d, m = grid
    for ranks in _by_model_rank([r[case] for r in grids[grid]], m):
        check_ranks(ranks, *jax_refs[case.split("_")[0]], d)


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
@pytest.mark.parametrize("case", ["hier", "flat"])
def test_split_steps_match_the_one_process_step(references, grids, case, grid):
    _, _, port_refs = references
    d, m = grid
    for ranks in _by_model_rank([r[case] for r in grids[grid]], m):
        check_ranks(ranks, *port_refs[case], d)


BF16_TOL = 2.0 ** -8  # bfloat16's unit roundoff


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_split_bf16_steps_match_the_one_process_bf16_step(references, grids, grid):
    """In bfloat16 (the default TPU.PRECISION) a split Linear rounds its
    output and its gradients once, after the sum over the model group, as
    one process's product does: each rank's losses and hidden states
    within bfloat16's unit roundoff of one process's bfloat16 step, each
    level's gradient (window 0, the same weights) within it relative to its
    norm, the parameters within Adam's 2·lr a step (a gradient that is
    rounding noise, such as a key bias's under the softmax, may take
    either sign), whole tensors equal across the ranks, and the val step's
    losses within the roundoff."""
    _, _, port_refs = references
    ref_windows, ref_val = port_refs["hier_bf16"]
    d, m = grid
    for ranks in _by_model_rank([r["hier_bf16"] for r in grids[grid]], m):
        for w, ref in enumerate(ref_windows):
            params0 = ranks[0]["windows"][w]["params"]
            for i, res in enumerate(ranks):
                got = res["windows"][w]
                for key, want in ref["metrics"].items():
                    assert abs(got["metrics"][key] - want) <= BF16_TOL, (grid, w, i, key)
                for h, want in zip(got["hidden"], ref["hidden"]):
                    err = (h.float() - torch.from_numpy(_rows(_np(want), i, d))).abs().max()
                    assert err <= BF16_TOL, (grid, w, i, float(err))
                for level in ("high", "low") if w == 0 else ():
                    names = [n for n in ref["grads"] if n.startswith(f"{level}.")]
                    a, b = (torch.cat([g[n].reshape(-1) for n in names])
                            for g in (got["grads"], ref["grads"]))
                    assert (a - b).norm() <= BF16_TOL * b.norm(), (grid, i, level)
                for name, p in got["params"].items():
                    assert torch.equal(p, params0[name]), (grid, w, i, name)
                    assert (p - ref["params"][name]).abs().max() <= 2 * LR * (w + 1), name
        for res in ranks:
            for key, want in ref_val["metrics"].items():
                assert abs(res["val"]["metrics"][key] - want) <= BF16_TOL, (grid, key)


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
@pytest.mark.parametrize("case", ["hier", "flat"])
def test_each_rank_holds_its_slices(grids, case, grid):
    """Gathered tensors equal on every rank; a rank's own tensors are its
    slices of them; the data groups' slices and the model groups' whole
    tensors bitwise equal; the Adam moments the slices' shapes."""
    d, m = grid
    results = grids[grid]
    assert [r["place"] for r in results] == [(i, j) for i in range(d) for j in range(m)]
    plans = results[0][case]["plans"]
    split = {f"{level}.{n}": dim for level, plan in plans.items()
             for n, dim in plan.items() if dim is not None}
    assert split
    for w in range(2):
        ref = results[0][case]["windows"][w]
        for rank, res in enumerate(results):
            got = res[case]["windows"][w]
            j = rank % m
            assert res[case]["plans"] == plans
            for name, whole in got["params"].items():
                assert torch.equal(whole, ref["params"][name]), (rank, name)
                local = got["local"][name]
                if name in split:
                    k = whole.shape[split[name]] // m
                    assert torch.equal(local, whole.narrow(split[name], j * k, k)), name
                    assert local.numel() * m == whole.numel()
                else:
                    assert torch.equal(local, whole), name
                # the data group: the same model rank; the model group: the same data rank
                first_of_data_group = results[j][case]["windows"][w]["local"][name]
                assert torch.equal(local, first_of_data_group), (rank, name)
                first_of_model_group = results[rank - j][case]["windows"][w]["local"][name]
                if name not in split:
                    assert torch.equal(local, first_of_model_group), (rank, name)
        for rank, res in enumerate(results):
            for name, moments in res[case]["moments"].items():
                assert moments and all(v.shape == res[case]["windows"][-1]["local"][name].shape
                                       for v in moments), name


# -- (d) checkpoints -------------------------------------------------------------------

TOL = 1e-5


def train(opts, mesh):
    """A trainer run: at ``[-1, 1]`` one process through run_exp; on a grid
    the ranks run_exp starts (run._train_rank), each splitting the kernels
    of at least MIN_SIZE elements."""
    if mesh == [-1, 1]:
        run_exp(None, "train", opts)
        return
    d, m = mesh_lib.mesh_axes(mesh, "cpu")
    mesh_lib.spawn(torch_tp_ranks.train_rank, d * m, "cpu", MIN_SIZE, None, opts,
                   timeout_s=600)


def _opts(root, run, mesh, **extra):
    return tiny_opts(root, batch_size=2, **{
        "TPU.MESH_SHAPE": mesh, "TPU.PRECISION": "float32",
        "MODEL.VISUAL_LING_ATTN.dropout": 0.0, "DAGGER.EPOCHS": 2,
        "DAGGER.MAX_EPOCHS_PER_RUN": 1, "DAGGER.RESUME": True,
        "CHECKPOINT_FOLDER": str(root / run / "ckpts"),
        "TENSORBOARD_DIR": str(root / run / "tb"), **extra})


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """ckpt.2 and ckpt.3 of one process, of [1, 2] (each epoch a run, the
    second resuming), and of one process resuming [1, 2]'s ckpt.2."""
    root = tmp_path_factory.mktemp("tp_ckpt")
    fill_buffer(str(root / "train_buf"), np.random.default_rng(6), n_eps=4, hw=32)
    fill_buffer(str(root / "eval_buf"), np.random.default_rng(7), n_eps=2, hw=32)
    for run, mesh in (("one", [-1, 1]), ("split", [1, 2])):
        for _ in range(2):
            train(_opts(root, run, mesh), mesh)
    os.makedirs(root / "mixed" / "ckpts")
    shutil.copytree(root / "split" / "ckpts" / "ckpt.2", root / "mixed" / "ckpts" / "ckpt.2")
    run_exp(None, "train", _opts(root, "mixed", [-1, 1]))
    out = {run: {name: torch.load(root / run / "ckpts" / name / ckpt_lib.TRAIN_STATE,
                                  weights_only=True)
                 for name in ("ckpt.2", "ckpt.3")} for run in ("one", "split", "mixed")}
    out["log"] = (root / "train.log").read_text()
    shutil.rmtree(root)
    return out


def _close(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _close(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        torch.testing.assert_close(a, b, atol=TOL, rtol=0, msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("run,name", [("split", "ckpt.2"), ("split", "ckpt.3"),
                                      ("mixed", "ckpt.3")])
def test_a_split_run_writes_the_one_process_checkpoint(checkpoints, run, name):
    """Keys, shapes and dtypes the one process's, every weight and moment
    within 1e-5: the file is whole, whichever grid wrote or resumed it."""
    _close(checkpoints[run][name], checkpoints["one"][name], f"{run}/{name}")
    # both [1, 2] runs split the tiny kernels of at least MIN_SIZE elements
    assert checkpoints["log"].count("model axis of 2: 27 tensors split") == 2


def test_the_checkpoint_loads_into_a_split_trainer_as_its_slices(checkpoints, tmp_path):
    """Loading a whole checkpoint into split policies keeps each rank's
    slices of the weights and moments (a model axis of 2, rank 1's side,
    without a group: the slicing alone)."""
    from robo_vln_tpu_torch.parallel import tensor
    from robo_vln_tpu_torch.parallel.mesh import AxisGroup
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer

    saved = checkpoints["one"]["ckpt.3"]
    path = tmp_path / "ckpt.3"
    os.makedirs(path)
    torch.save(saved, path / ckpt_lib.TRAIN_STATE)
    trainer = HierarchicalTrainer(get_config(opts=_opts(tmp_path, "x", [-1, 1])))
    trainer._setup_policy()

    class Rank1:
        model_group = AxisGroup(size=2, rank=1)
        model_size = 2

    plans = {level: mesh_lib.param_shardings(m, 2, MIN_SIZE)
             for level, m in (("high", trainer.high), ("low", trainer.low))}
    for level in ("high", "low"):
        tensor.shard_modules(getattr(trainer, level), plans[level], Rank1)
    state = ckpt_lib.load_checkpoint(str(path), trainer.high, trainer.low, trainer.state)
    for level, module, opt in (("high", trainer.high, state.high.optimizer),
                               ("low", trainer.low, state.low.optimizer)):
        whole = saved[f"{level}_level_state_dict"]
        names = saved[f"{level}_param_names"]
        for name, p in module.named_parameters():
            dim = plans[level][name]
            want = whole[name] if dim is None else whole[name].chunk(2, dim)[1]
            assert torch.equal(p.detach(), want), name
        for index, entry in opt.state_dict()["state"].items():
            dim = plans[level][names[index]]
            for k in ("exp_avg", "exp_avg_sq"):
                w = saved[f"{level}_optimizer"]["state"][index][k]
                assert torch.equal(entry[k], w if dim is None else w.chunk(2, dim)[1]), k
    assert any(d is not None for d in plans["high"].values())


def test_a_split_run_featurizes_as_one_process(tmp_path):
    """DAGGER.PRELOAD_TRUNK_FEATURES on [1, 2] (BERT's tables and products
    split): rank 0 featurizes on a whole copy of the high level, so the
    feature store, its fingerprint included, is one process's byte for
    byte, and the split run trains from it."""
    import json

    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
    from robo_vln_tpu_torch.training import featurize

    stores = {}
    for run, mesh in (("one", [-1, 1]), ("split", [1, 2])):
        root = tmp_path / run
        fill_buffer(str(root / "train_buf"), np.random.default_rng(8), n_eps=2, hw=32)
        train(_opts(root, run, mesh, **{
            "DAGGER.PRELOAD_TRUNK_FEATURES": True, "TPU.SYNC_FROZEN_TRUNKS_ON_INIT": True,
            "DAGGER.EPOCHS": 1}), mesh)
        assert ckpt_lib.list_checkpoints(str(root / run / "ckpts"))
        out = str(root / "train_buf") + ".features"
        with open(os.path.join(out, featurize.META)) as f:
            meta = json.load(f)
        with TrajectoryStore(out) as store:
            stores[run] = (meta["fingerprint"], meta["episodes"],
                           [store.get(i) for i in range(len(store))])
    assert stores["split"] == stores["one"] and stores["one"][1] == 2


def test_the_flat_trainer_trains_on_a_model_axis(tmp_path):
    """robo_vln_trainer on [1, 2] (Seq2Seq with the progress monitor, its
    kernels of 256 elements or more split) writes the one-process run's
    checkpoint within 1e-5."""
    from tests.test_torch_flat_trainer import SEQ2SEQ_PM, SIMPLE_PX, flat_opts

    states = {}
    for run, mesh in (("one", [-1, 1]), ("split", [1, 2])):
        root = tmp_path / run
        fill_buffer(str(root / "train_buf"), np.random.default_rng(9), n_eps=4, hw=SIMPLE_PX)
        train(flat_opts(root, batch_size=2, **{
            **SEQ2SEQ_PM, "TPU.MESH_SHAPE": mesh}), mesh)
        (ckpt,) = ckpt_lib.list_checkpoints(str(root / "ckpts"))
        states[run] = torch.load(os.path.join(ckpt, ckpt_lib.TRAIN_STATE), weights_only=True)
    _close(states["split"], states["one"], "flat")
    split = re.search(r"model axis of 2: (\d+) tensors split",
                      (tmp_path / "split" / "train.log").read_text())
    assert split and int(split.group(1)) > 0


POSITION_TOL = 1e-4  # metres, tests/test_torch_dagger.py's
MIXED_ACTION_TOL = 1e-6  # the policy's float32 actions from weights one step's rounding apart


@pytest.mark.parametrize("trainer", ["hierarchical_trainer", "robo_vln_trainer"])
def test_a_split_run_collects_with_its_policies_as_one_process(tmp_path, trainer):
    """DAGGER.ITERATIONS 2 at P 0.5 on [1, 2]: the expert's episodes, an
    epoch on split policies, then a collection that the trained policies
    drive at beta 0.5.  Rank 0 collects on whole copies of them, which
    every rank gathers (a split policy run by rank 0 alone would wait in
    its first collective).  The expert's episodes are one process's byte
    for byte; the mixed ones take the same steps and stops, with every
    observation bitwise but the position, which the policy's actions move
    (their weights within the step's rounding of one process's)."""
    from tests.test_torch_collection import collect_opts, read_buffer
    from tests.test_torch_flat_trainer import MIXER_OPTS

    extra = MIXER_OPTS if trainer == "robo_vln_trainer" else {
        "TPU.PRECISION": "float32", "MODEL.VISUAL_LING_ATTN.dropout": 0.0}
    buffers = {}
    for run, mesh in (("one", [-1, 1]), ("split", [1, 2])):
        root = tmp_path / run
        train(collect_opts(root, trainer, **{**extra, "TPU.MESH_SHAPE": mesh,
                                             "DAGGER.ITERATIONS": 2, "DAGGER.P": 0.5}), mesh)
        buffers[run] = read_buffer(root / "train_buf")
        assert "DAgger mixed collection: beta=0.5000" in (root / "train.log").read_text()
    got, want = buffers["split"], buffers["one"]
    assert len(got) == len(want) == 4
    assert [raw for raw, _ in got[:2]] == [raw for raw, _ in want[:2]]
    for (_, (obs, prev, corr, stops)), (_, (wobs, wprev, wcorr, wstops)) in zip(got[2:], want[2:]):
        assert obs.keys() == wobs.keys() and list(stops) == list(wstops)
        for k in wobs:
            g, w = np.asarray(obs[k]), np.asarray(wobs[k])
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if k == "globalgps":
                np.testing.assert_allclose(g, w, rtol=0, atol=POSITION_TOL)
            else:
                assert np.array_equal(g, w), k
        for g, w in ((prev, wprev), (corr, wcorr)):
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                       rtol=0, atol=MIXED_ACTION_TOL)
    split = re.search(r"model axis of 2: (\d+) tensors split",
                      (tmp_path / "split" / "train.log").read_text())
    assert split and int(split.group(1)) > 0
