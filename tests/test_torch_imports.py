"""The port stands alone: importing robo_vln_tpu_torch and every submodule
loads neither JAX, flax, optax nor anything of robo_vln_tpu, and no source
of the port or chip_smoke.py names them in an import, not even one inside a
function.  Nor msgpack or lmdb, which the card's machine lacks (the port has
its own msgpack codec and store).  Importing every module loads neither
PyYAML nor TensorBoard either: the port reads a yaml, and makes a
TensorBoard writer, only when asked to."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "robo_vln_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "robo_vln_tpu", "msgpack", "lmdb")
NOT_ON_IMPORT = FORBIDDEN + ("yaml", "tensorboard", "tensorboardX", "tensorflow")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import robo_vln_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'robo_vln_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_ON_IMPORT!r})\n"
        "print('LOADED', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, loaded = proc.stdout.strip().splitlines()[-2:]
    assert int(count) >= 39  # every module of the slices so far was imported
    assert loaded == "LOADED []"


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_port_modules_are_all_checked():
    names = {m.name for m in pkgutil.walk_packages([str(PORT)])}
    assert {"ops", "models", "config", "utils", "eval", "training", "data", "envs",
            "parallel", "run"} <= names
    checked = {p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")}
    assert {f"robo_vln_tpu_torch/{m}.py" for m in (
        "ops/losses", "training/optimizers", "training/steps", "training/checkpoint",
        "training/trainer", "training/hierarchical_trainer", "data/serialization",
        "data/trajectory_store", "data/loader", "envs/async_env", "utils/registry",
        "utils/logging", "config/task", "envs/expert", "envs/collection", "envs/dagger",
        "training/featurize", "eval/ondevice", "run", "parallel/mesh", "parallel/dryrun",
        "data/parallel_loader")} <= checked


def test_the_loaders_workers_load_no_torch():
    """The process-parallel loader's spawned workers import its module and
    the store's (the native store's ctypes wrapper among them): neither
    loads torch, whose import would add seconds to each worker's start."""
    code = ("import sys\n"
            "import robo_vln_tpu_torch.data.parallel_loader, robo_vln_tpu_torch.data.trajectory_store\n"
            "print('torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "False"
