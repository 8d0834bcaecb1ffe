"""The port's data plane (data/serialization.py, data/trajectory_store.py,
data/loader.py, envs/async_env.window_stream) against the JAX package's.

* The port's msgpack codec writes what ``msgpack.packb(..., use_bin_type=True)``
  writes through the JAX package's ``serialization.packb``, byte for byte,
  over episode layouts and hypothesis-drawn nested values that cross every
  fix/8/16/32-bit length boundary and every integer width; each package
  decodes the other's bytes to equal values, and the port's decoded arrays
  are views over the source buffer.
* The flat format: identical bytes, decoded across packages, views.
* Stores written by either package read in the other, the JAX side on its
  native and its Python backend.
* ``TrajectoryDataset`` -> ``batch_iterator`` -> ``split_tbptt`` give
  bitwise-equal windows (keys, dtypes, arrays) for the same store and seed.
* ``window_stream`` keeps the order and the first-window flags and raises
  the worker's error.

Every comparison is exact: no tolerance.
"""

import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from robo_vln_tpu.data import loader as jax_loader
from robo_vln_tpu.data import serialization as jax_ser
from robo_vln_tpu.data.trajectory_store import TrajectoryStore as JaxStore
from robo_vln_tpu_torch.data import loader, serialization
from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
from robo_vln_tpu_torch.envs.async_env import device_transfer, window_stream
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# every length at which msgpack's encoding of a str, bin, array or map
# changes class (fix -> 8 -> 16 -> 32 bits), and one either side
LENGTHS = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)
# every integer width and sign boundary
INT_EDGES = (0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63)


def assert_same(a, b, path="value"):
    """Equal values, types, dtypes and shapes, recursively."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def episode(rng, t, hw=8, bert=True, glove=True, dtype_rgb=np.uint8):
    obs = {
        "rgb": rng.integers(0, 255, (t, hw, hw, 3)).astype(dtype_rgb),
        "depth": rng.random((t, hw, hw, 1)).astype(np.float16),
        "progress": np.linspace(0, 1, t).astype(np.float32),
        "vln_oracle_action_sensor": rng.integers(1, 4, (t, 1)).astype(np.float64),
    }
    if bert:
        obs["instruction"] = np.tile(rng.integers(1, 50, (1, 10)), (t, 1)).astype(np.int32)
    else:
        obs["instruction"] = np.tile(rng.integers(1, 50, (1, 7)).astype(np.float64), (t, 1))
    if glove:
        obs["glove_tokens"] = np.tile(rng.integers(1, 50, (1, 6)).astype(np.float64), (t, 1))
    return (obs, rng.standard_normal((t, 2)), rng.standard_normal((t, 2)) * 0.5 + 0.5,
            [t - 1] * t)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("t,bert,glove,rgb_dtype", [
    (1, True, True, np.uint8), (7, True, False, np.uint8),
    (40, False, True, np.float32), (300, False, False, np.uint8)])
def test_episode_bytes_match_jax(flat, t, bert, glove, rgb_dtype):
    """An episode packs to the JAX package's bytes (msgpack or flat), and
    each package decodes the other's bytes to the same values."""
    args = episode(np.random.default_rng(t), t, bert=bert, glove=glove, dtype_rgb=rgb_dtype)
    pack, jax_pack = ((loader.pack_episode_flat, jax_loader.pack_episode_flat) if flat
                      else (loader.pack_episode, jax_loader.pack_episode))
    data = pack(*args)
    assert data == jax_pack(*args)
    assert serialization.is_flat(data) == flat
    assert_same(serialization.unpackb_any(data), jax_ser.unpackb_any(data))


_ints = st.one_of(st.sampled_from(INT_EDGES), st.integers(-2**63, 2**64 - 1))
_sized_text = st.sampled_from(LENGTHS).map(lambda n: "ü" * (n // 2) + "a" * (n % 2))
_sized_bin = st.sampled_from(LENGTHS).map(lambda n: bytes(range(256)) * (n // 256)
                                          + bytes(n % 256))
_arrays = st.tuples(
    st.sampled_from(["u1", "i2", "<i4", ">i8", "<f2", "<f4", "<f8", "?"]),
    st.lists(st.integers(0, 4), max_size=3),
).map(lambda dt_shape: np.arange(int(np.prod(dt_shape[1])), dtype=np.float64)
      .astype(dt_shape[0]).reshape(dt_shape[1]))
_np_scalars = st.one_of(st.integers(-100, 100).map(np.int32), st.floats(-1e3, 1e3).map(np.float32),
                        st.booleans().map(np.bool_), st.floats(-1e3, 1e3).map(np.float64))
_leaves = st.one_of(st.none(), st.booleans(), _ints,
                    st.floats(allow_nan=False), st.text(max_size=40), st.binary(max_size=40),
                    _sized_text, _sized_bin, _arrays, _np_scalars)
_keys = st.one_of(st.text(max_size=8), st.binary(max_size=8), st.integers(-5, 300)).filter(
    lambda k: k not in ("nd", b"nd"))  # not a msgpack_numpy tag
_values = st.recursive(
    _leaves,
    lambda inner: st.one_of(st.lists(inner, max_size=18),
                            st.dictionaries(_keys, inner, max_size=18)),
    max_leaves=40)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_packb_matches_jax(value):
    """Nested values: the port's bytes are msgpack's, and each package
    decodes the other's bytes (bytes, bytearray or a uint8 array) to equal
    values."""
    data = serialization.packb(value)
    assert data == jax_ser.packb(value)
    for src in (data, bytearray(data), np.frombuffer(data, np.uint8).copy()):
        assert_same(serialization.unpackb(src), jax_ser.unpackb(src))


@pytest.mark.parametrize("n", [15, 16, 65535, 65536])
def test_container_length_classes(n):
    """Arrays and maps at the fix / 16-bit / 32-bit boundaries."""
    for value in (list(range(n)), {i: i % 7 for i in range(n)}):
        data = serialization.packb(value)
        assert data == jax_ser.packb(value)
        assert_same(serialization.unpackb(data), jax_ser.unpackb(data))


def test_codec_refuses_what_it_does_not_cover():
    with pytest.raises(OverflowError):
        serialization.packb(2**64)
    with pytest.raises(TypeError):
        serialization.packb(object())
    with pytest.raises(ValueError, match="ext"):
        serialization.unpackb(b"\xd4\x01\x00")  # fixext 1
    with pytest.raises(ValueError, match="ends"):
        serialization.unpackb(jax_ser.packb([1, 2, 3])[:-1])


@pytest.mark.parametrize("flat", [False, True])
def test_decoded_arrays_are_views(flat):
    """Decoding copies no array: each is a view over the source buffer."""
    obs, prev, corr, stop = episode(np.random.default_rng(1), 12)
    pack = loader.pack_episode_flat if flat else loader.pack_episode
    buf = np.frombuffer(pack(obs, prev, corr, stop), np.uint8).copy()
    dec_obs, dec_prev, dec_corr, _ = serialization.unpackb_any(buf)
    for name, arr in list(dec_obs.items()) + [("prev", dec_prev), ("corr", dec_corr)]:
        assert np.shares_memory(arr, buf), name
    assert_same(dec_obs["rgb"], obs["rgb"])
    assert_same(dec_corr, corr)


def test_flat_round_trip_across_packages():
    rng = np.random.default_rng(2)
    tree = {"a": rng.random((3, 5)).astype(np.float32), "b": [np.int64(7), 3, "x", None],
            "c": {"d": np.zeros((0, 4), np.uint8), "e": rng.integers(0, 9, (65,))}}
    data = serialization.pack_flat(tree)
    assert data == jax_ser.pack_flat(tree)
    buf = bytearray(data)
    got = serialization.unpack_flat(buf)
    assert_same(got, jax_ser.unpack_flat(buf))
    assert np.shares_memory(got["a"], buf) and np.shares_memory(got["c"]["e"], buf)
    assert_same(jax_ser.unpack_flat(serialization.pack_flat(tree)), got)


def _fill(store, rng, n, flat_every=2, **kw):
    for k in range(n):
        t = int(rng.integers(5, 13))
        loader.write_episode(store, k, *episode(rng, t, **kw), flat=k % flat_every == 1)
    store.flush()


@pytest.mark.parametrize("writer,reader", [
    ("port", "jax-native"), ("port", "jax-python"), ("jax-native", "port"),
    ("jax-python", "port")])
def test_store_reads_across_packages(tmp_path, writer, reader):
    def open_store(who, writable):
        if who == "port":
            return TrajectoryStore(str(tmp_path), writable=writable)
        store = JaxStore(str(tmp_path), writable=writable, backend=who.split("-")[1])
        # the JAX facade falls back to Python silently: hold it to the backend named
        assert type(store._impl).__name__ == {"jax-native": "_NativeStore",
                                              "jax-python": "_PythonStore"}[who]
        return store

    rng = np.random.default_rng(3)
    values = {k: rng.bytes(int(rng.integers(0, 3000))) for k in (0, 5, 1, 2**40)}
    with open_store(writer, True) as store:
        for k, v in values.items():
            store.put(k, v)
        store.put(5, b"overwritten")  # the last entry of a key wins
        store.flush()
    values[5] = b"overwritten"
    with open_store(reader, False) as store:
        assert len(store) == len(values)
        for k, v in values.items():
            assert store.get(k) == v
            assert store.get_buffer(k).tobytes() == v


def _windows(pkg, path, seed, batch, buckets, tbptt, is_bert, use_iw=True):
    ds = pkg.TrajectoryDataset(path, batch_size=batch, is_bert=is_bert, use_iw=use_iw,
                               inflection_weight_coef=3.2, seed=seed)
    out = [w for b in pkg.batch_iterator(ds, batch, buckets, 12)
           for w in pkg.split_tbptt(b, tbptt)]
    return ds, out


@pytest.mark.parametrize("is_bert,glove,use_iw,n_eps", [
    (True, True, True, 7), (True, False, False, 8), (False, True, True, 9),
    (False, False, False, 6)])
def test_loader_matches_jax(tmp_path, is_bert, glove, use_iw, n_eps):
    """The same store and seed give bitwise the same windows, in the same
    order, through either package's loader; with a batch of 4, 7 and 9
    episodes end in a padded tail batch."""
    path = str(tmp_path / "buf")
    with TrajectoryStore(path, writable=True) as store:
        _fill(store, np.random.default_rng(4), n_eps, bert=is_bert, glove=glove)
    for seed in (0, 1):
        ds, got = _windows(loader, path, seed, 4, [8, 16], 4, is_bert, use_iw)
        jds, want = _windows(jax_loader, path, seed, 4, [8, 16], 4, is_bert, use_iw)
        assert np.array_equal(ds.inflec_weights, jds.inflec_weights)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_same(g, w)
    assert got[-1]["valid_mask"][-1].sum() == 0 or n_eps % 4 == 0


def test_window_stream_order_and_flags():
    """Windows come out in order with the first-window flag of each batch,
    as numpy windows turned into CPU tensors that share their memory."""
    batches = [{"x": np.arange(b * 100, b * 100 + 4 * n).reshape(1, 4 * n).astype(np.float32),
                "instruction": np.full((1, 3), b, np.int32)} for b, n in ((0, 3), (1, 1), (2, 2))]
    split = lambda batch: loader.split_tbptt(  # noqa: E731
        {**batch, "prev_actions": batch["x"][..., None]}, 4)
    send, receive = device_transfer("cpu")
    assert receive is None
    got = list(window_stream(iter(batches), send, split))
    assert [first for first, _ in got] == [True, False, False, True, True, False]
    want = [w for b in batches for w in split(b)]
    for (_, g), w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            assert np.array_equal(g[k].numpy(), w[k])


def test_window_stream_raises_worker_errors_and_stops_its_worker():
    def batches():
        yield {"prev_actions": np.zeros((1, 8, 2), np.float32)}
        raise RuntimeError("decode failed")

    split = lambda b: loader.split_tbptt(b, 4)  # noqa: E731
    stream = window_stream(batches(), lambda w: w, split)
    assert next(stream)[0] is True
    assert next(stream)[0] is False
    with pytest.raises(RuntimeError, match="decode failed"):
        next(stream)

    def workers():
        return [t for t in threading.enumerate() if t.name == "window_stream"]

    assert workers() == []  # the failed stream's worker was joined
    many = ({"prev_actions": np.zeros((1, 8, 2), np.float32)} for _ in range(100))
    stream = window_stream(many, lambda w: w, split)
    next(stream)
    assert len(workers()) == 1
    stream.close()  # the consumer stops early: the worker is stopped and joined
    assert workers() == []
