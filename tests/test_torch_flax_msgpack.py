"""The port's reader of flax msgpack files (``vil_tpu_torch/utils/flax_msgpack.py``)
against ``flax.serialization``, and ``chip_smoke.py``'s encoder against
``flax.serialization.to_bytes``, on hypothesis trees: f32, f16, bf16 (read
widened to f32, bit for bit), int32, int64, bool and uint8 arrays of 0-3
dimensions, empty ones among them; 0-d numpy scalars (ext 3); nested and
empty maps; str, int, float, bool and nil; arrays past 64 KiB (bin32 and
ext32 records). Also: a file read through its mapping (read-only views),
flax's chunked arrays, and what raises.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from vil_tpu_torch.utils import flax_msgpack

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

DTYPES = ["float32", "float16", "bfloat16", "int32", "int64", "bool", "uint8"]
BIG = 20000  # elements: 80 KB of f32, past bin16's and ext16's 64 KiB


def _array(dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype in ("int32", "int64", "uint8"):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
    values = np.asarray(rng.standard_normal(shape) * 100, np.float32)
    return values.astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)


_shapes = st.one_of(st.lists(st.integers(0, 4), max_size=3).map(tuple), st.just((BIG,)))
arrays = st.builds(_array, st.sampled_from(DTYPES), _shapes, st.integers(0, 2**32 - 1))
scalars = st.builds(lambda a: a.reshape(-1)[0] if a.size else a.dtype.type(0),
                    st.builds(_array, st.sampled_from(DTYPES), st.just((1,)),
                              st.integers(0, 2**32 - 1)))
python_leaves = st.one_of(st.text(max_size=40), st.integers(-2**63, 2**64 - 1),
                          st.floats(allow_nan=False), st.booleans(), st.none())
keys = st.text(st.characters(codec="utf-8"), max_size=12)
leaves = st.one_of(arrays, scalars, python_leaves)
trees = st.recursive(leaves, lambda kids: st.dictionaries(keys, kids, max_size=5), max_leaves=12)
state_dicts = st.dictionaries(keys, trees, max_size=5)


def _assert_same(ours, ref, where="tree"):
    """``ours`` (the port's reader) is ``ref`` (flax's), a bfloat16 array
    widened to f32 bit for bit."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), where
        for k in ref:
            _assert_same(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert isinstance(ours, np.ndarray) == isinstance(ref, np.ndarray), where
        assert isinstance(ours, np.generic) == isinstance(ref, np.generic), where
        ref = np.asarray(ref)
        if ref.dtype == jnp.bfloat16:
            ref = ref.astype(np.float32)
        got = np.asarray(ours)
        assert got.dtype == ref.dtype and got.shape == ref.shape, where
        assert got.tobytes() == ref.tobytes(), where
    else:
        assert type(ours) is type(ref) and ours == ref, where


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=trees)
def test_reader_matches_flax(tree):
    data = serialization.msgpack_serialize(tree)
    _assert_same(flax_msgpack.loads(data), serialization.msgpack_restore(data))


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=state_dicts)
def test_chip_smoke_encoder_matches_to_bytes(tree):
    assert chip_smoke.flax_msgpack_bytes(tree) == serialization.to_bytes(tree)


def test_lists_and_a_file_through_its_mapping(tmp_path):
    tree = {"params": {"Dense_0": {"kernel": _array("float32", (3, 5), 1),
                                   "bias": _array("bfloat16", (5,), 2)}},
            "opt_state": {"0": {"count": np.array(7, np.int32), "mu": {}}, "1": {}},
            "lr_scale": np.float32(0.1), "steps": [1, -40, 70000, "x", None]}
    data = serialization.msgpack_serialize(tree)
    path = tmp_path / "state.ckpt"
    path.write_bytes(data)
    ours = flax_msgpack.load(str(path))
    _assert_same(ours, serialization.msgpack_restore(data))
    kernel = ours["params"]["Dense_0"]["kernel"]
    assert not kernel.flags.writeable  # a view of the mapping, not a copy
    assert flax_msgpack.starts_a_map(str(path))
    assert chip_smoke.flax_msgpack_bytes({k: v for k, v in tree.items() if k != "steps"}) == \
        serialization.to_bytes({k: v for k, v in tree.items() if k != "steps"})


def test_chunked_arrays_are_joined(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": _array("float32", (7, 9), 3), "small": _array("int64", (2,), 4)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same(flax_msgpack.loads(data), serialization.msgpack_restore(data))


def test_what_raises():
    with pytest.raises(ValueError, match="ext 2"):
        flax_msgpack.loads(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(serialization.msgpack_serialize({"a": np.zeros(3)})[:-1])
    with pytest.raises(ValueError, match="after the msgpack object"):
        flax_msgpack.loads(serialization.msgpack_serialize({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="starts no msgpack object"):
        flax_msgpack.loads(b"\xc1")
