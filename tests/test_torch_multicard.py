"""scripts/multicard_smoke.py on the CPU: its phase-A ranks (step_rank) as
four gloo ranks on the tiny HCM, over the grids ``[4, 1]``, ``[2, 2]`` and
``[1, 4]`` in one spawn, and its refusal of fewer cards than ranks.

The ranks step tests/test_torch_mesh.py's two global windows (B=4, T=4,
the shards' counts differing, dropout off, float32) from the JAX package's
variables (tests/torch_multicard_ranks.TinySetup), every kernel of at
least 256 elements split over the model axis, then the val step on the
first window, then two bfloat16 steps.  Each grid is held, through
tests/test_torch_mesh.check_ranks (losses, hidden rows, gradients within
1e-4; the parameters within 0.01·lr where the reference gradient is above
1e-6 and 2·lr a step elsewhere; every rank of a data group bitwise equal),
to the port's one-process step and to the JAX package's single-device step
on the same windows.  The bfloat16 steps must give finite metrics, with the
ranks' slices and whole weights equal across their groups; the bytes a
rank holds fall with the model axis.  The script itself runs on a machine
with four cards.
"""

import shutil

import pytest
import torch

from robo_vln_tpu_torch.models import build_hierarchical_policies
from robo_vln_tpu_torch.ops import _build
from robo_vln_tpu_torch.parallel import mesh as mesh_lib
from scripts import multicard_smoke
from tests.test_torch_mesh import check_ranks, hier_windows, jax_hier_reference, port_reference
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import tiny_configs
from tests.torch_multicard_ranks import TinySetup

N = 4
GRIDS = [(4, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def references():
    windows = hier_windows()
    case, ref = port_reference("hier", windows)
    _, mc = tiny_configs()
    mc.VISUAL_LING_ATTN.dropout = 0.0
    bf16 = dict(zip(("high", "low"), build_hierarchical_policies(mc, compute_dtype=torch.bfloat16)))
    for level, m in bf16.items():
        m.load_state_dict(case["modules"][level].state_dict())
    setup = TinySetup(case["modules"], bf16, windows)
    return setup, (ref["windows"], ref["val"]), jax_hier_reference(windows)


@pytest.fixture(scope="module")
def ranks(references, tmp_path_factory):
    setup, _, _ = references
    out = tmp_path_factory.mktemp("multicard")
    mesh_lib.spawn(multicard_smoke.step_rank, N, "cpu", setup, GRIDS, str(out), timeout_s=600)
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(N)]
    shutil.rmtree(out)
    return results


def _by_model_rank(ranks, grid):
    """Each model rank's ranks, in data-rank order."""
    d, m = grid
    return [[r[grid]["float32"] for r in ranks][j::m] for j in range(m)]


def test_the_grids_of_n_ranks():
    assert multicard_smoke.grids(4) == GRIDS
    assert multicard_smoke.grids(2) == [(2, 1), (1, 2)]
    assert multicard_smoke.grids(8) == [(8, 1), (4, 2), (1, 8)]


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("grid", GRIDS)
def test_each_grid_matches_the_references(references, ranks, grid, against):
    _, port_ref, jax_ref = references
    ref = port_ref if against == "one_process" else jax_ref
    for group in _by_model_rank(ranks, grid):
        assert [r["place"][0] for r in group] == list(range(grid[0]))
        check_ranks(group, *ref, grid[0])


@pytest.mark.parametrize("grid", GRIDS)
def test_each_grid_takes_bf16_steps(ranks, grid):
    """Finite metrics on every rank, the slices and whole weights equal
    across each rank's groups after the steps, every step and all-reduce
    timed by the host clock (the events need a card)."""
    d, m = grid
    for rank, res in enumerate(ranks):
        bf16 = res[grid]["bfloat16"]
        assert bf16["steps"] == 2 and len(bf16["step_ms"]) == 2
        assert len(bf16["reduce_ms"]) == 2  # at [1, 4] the one-rank data group's copy alone
        assert all(h > 0 for _, h in bf16["step_ms"])
        assert all(torch.isfinite(torch.tensor(v)) for step in bf16["losses"]
                   for v in step.values()), rank
        assert bf16["weights_agree"], rank
        assert res[grid]["float32"]["place"] == divmod(rank, m)


def test_a_model_axis_holds_fewer_bytes(references, ranks):
    """[4, 1] holds one process's parameters and moments on each rank;
    each model axis fewer, the wider one fewest."""
    setup, _, _ = references
    held = {grid: {r[grid]["float32"]["bytes"] for r in ranks} for grid in GRIDS}
    one = multicard_smoke.float32_step(setup, mesh_lib.DataMesh("cpu"), torch.device("cpu"))
    assert held[4, 1] == {one["bytes"]}
    assert max(held[1, 4]) < min(held[2, 2]) <= max(held[2, 2]) < one["bytes"]
    assert ranks[0][1, 4]["float32"]["split"] > 0


@pytest.mark.parametrize("cards", [1, 3])
def test_the_smoke_refuses_fewer_cards_than_ranks(monkeypatch, cards):
    """With fewer visible cards than ranks the script raises before it
    builds a kernel or starts a rank: no gloo, no fewer ranks, no CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh_lib, "visible_devices", lambda device: cards)
    monkeypatch.setattr(mesh_lib, "spawn", lambda *a, **k: pytest.fail("a rank started"))
    monkeypatch.setattr(_build, "build_all", lambda *a, **k: pytest.fail("a kernel was built"))
    with pytest.raises(RuntimeError, match=f"{cards} CUDA devices are visible"):
        multicard_smoke.main([str(N)])
