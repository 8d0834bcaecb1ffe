"""The port's trajectory store (data/trajectory_store.py: the native C++
store, sim/trajstore.cc, and the Python backend) against the JAX package's
two backends.

* The same writes (keys out of order, an empty value, a key written twice)
  give byte-equal ``store.dat`` and ``store.idx`` through each of the four
  writers: the port's native and Python backends, the JAX package's native
  and Python backends.
* Each of the port's backends reads every one of those stores, and each of
  the JAX package's backends reads the port's: every key, the last write of
  a key winning, the count.
* The facade: ``ROBO_VLN_STORE_BACKEND`` picks the backend (native by
  default), a store whose native build fails falls back to the Python
  backend, and a read-only store refuses a write in either backend.
* A buffer the port's loader reads through either backend gives the same
  batches bitwise.
"""

import filecmp

import numpy as np
import pytest

from robo_vln_tpu.data.trajectory_store import TrajectoryStore as JaxStore
from robo_vln_tpu_torch.data import trajectory_store as store_lib
from robo_vln_tpu_torch.data.loader import TrajectoryDataset, batch_iterator, write_episode
from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
from tests.test_data import _make_episode
from tests.test_torch_threads import one_torch_thread  # noqa: F401

PORT = ("native", "python")
WRITERS = [("port", b) for b in PORT] + [("jax", b) for b in PORT]


def _values():
    rng = np.random.default_rng(0)
    keys = [5, 0, 3, 1, 4, 2]
    values = {k: rng.bytes(int(rng.integers(1, 3000))) for k in keys}
    values[4] = b""
    return keys, values


def _open(kind, backend, path, writable=False):
    cls = TrajectoryStore if kind == "port" else JaxStore
    return cls(str(path), writable=writable, backend=backend)


def _write(kind, backend, path):
    keys, values = _values()
    with _open(kind, backend, path, writable=True) as store:
        for k in keys:
            store.put(k, values[k])
        store.put(3, b"rewritten")  # the last entry of a key wins
        assert store.get(3) == b"rewritten"
    return {**values, 3: b"rewritten"}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("stores")
    want = None
    for kind, backend in WRITERS:
        want = _write(kind, backend, root / f"{kind}_{backend}")
    return root, want


def test_native_backend_builds(tmp_path):
    """g++ builds sim/trajstore.cc into build/sim/ and ctypes opens it."""
    from robo_vln_tpu_torch.sim.build import library_path

    store = store_lib.NativeStore(str(tmp_path), writable=True)
    store.put(1, b"abc")
    assert store.get_buffer(1).tobytes() == b"abc" and len(store) == 1
    store.close()
    assert library_path("trajstore").exists()


@pytest.mark.parametrize("kind,backend", WRITERS[1:], ids=lambda x: str(x))
def test_the_same_writes_give_byte_equal_files(stores, kind, backend):
    root, _ = stores
    for name in ("store.dat", "store.idx"):
        assert filecmp.cmp(root / "port_native" / name, root / f"{kind}_{backend}" / name,
                           shallow=False), name


@pytest.mark.parametrize("reader", [("port", b) for b in PORT] + [("jax", b) for b in PORT],
                         ids=lambda x: "-".join(x))
def test_each_backend_reads_every_writers_store(stores, reader):
    root, want = stores
    writers = WRITERS if reader[0] == "port" else [("port", b) for b in PORT]
    for kind, backend in writers:
        with _open(*reader, root / f"{kind}_{backend}") as store:
            if reader[0] == "port":
                assert store.backend == reader[1]
            assert len(store) == len(want)
            for k, v in want.items():
                assert store.get(k) == v, (kind, backend, k)
                buf = store.get_buffer(k)
                assert buf.dtype == np.uint8 and buf.tobytes() == v
            with pytest.raises(KeyError):
                store.get(99)


def test_the_variable_picks_the_backend(tmp_path, monkeypatch):
    monkeypatch.delenv(store_lib.BACKEND_VAR, raising=False)
    with TrajectoryStore(str(tmp_path / "a"), writable=True) as store:
        assert store.backend == "native"
    monkeypatch.setenv(store_lib.BACKEND_VAR, "python")
    with TrajectoryStore(str(tmp_path / "a")) as store:
        assert store.backend == "python"
    monkeypatch.setenv(store_lib.BACKEND_VAR, "native")
    with TrajectoryStore(str(tmp_path / "a")) as store:
        assert store.backend == "native"
    with TrajectoryStore(str(tmp_path / "a"), backend="python") as store:
        assert store.backend == "python"


def test_a_failed_build_falls_back_to_python(tmp_path, monkeypatch):
    def no_compiler(name):
        raise RuntimeError("g++ not found: the host libraries cannot be built")

    monkeypatch.delenv(store_lib.BACKEND_VAR, raising=False)
    monkeypatch.setattr("robo_vln_tpu_torch.sim.build.load", no_compiler)
    with TrajectoryStore(str(tmp_path / "a"), writable=True) as store:
        assert store.backend == "python"
        store.put(0, b"x")
    monkeypatch.undo()
    with TrajectoryStore(str(tmp_path / "a")) as store:
        assert store.backend == "native" and store.get(0) == b"x"


@pytest.mark.parametrize("backend", PORT)
def test_read_only_store_refuses_a_write(tmp_path, backend):
    _write("port", backend, tmp_path)
    with TrajectoryStore(str(tmp_path), backend=backend) as store:
        with pytest.raises(IOError, match="read-only"):
            store.put(9, b"no")


def test_the_loader_reads_both_backends_alike(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    with TrajectoryStore(str(tmp_path / "buf"), writable=True, backend="native") as store:
        for k in range(5):
            write_episode(store, k, *_make_episode(rng, int(rng.integers(4, 10))), flat=k % 2)
    batches = {}
    for backend in PORT:
        monkeypatch.setenv(store_lib.BACKEND_VAR, backend)
        dataset = TrajectoryDataset(str(tmp_path / "buf"), batch_size=2, seed=3)
        batches[backend] = list(batch_iterator(dataset, 2, [6, 10], 12))
    assert len(batches["native"]) == 3
    for a, b in zip(batches["native"], batches["python"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
