"""The port's flax msgpack codec (``utils/flax_msgpack.py``) against flax.

  * ``from_bytes`` of ``flax.serialization.to_bytes`` trees: float32,
    bfloat16, int32, uint8 and bool arrays, numpy and Python scalars,
    complex numbers, strings, bytes, None, empty maps, lists and tuples
    (flax stores both as maps keyed "0", "1", ...);
  * arrays past ``MAX_CHUNK_SIZE``, forced small by monkeypatching flax's
    and the port's constant, joined again (bfloat16 too);
  * ``to_bytes`` byte-equal to flax's on the same trees, across every
    integer, string, bin, map and ext length form; msgpack arrays read in
    every length form;
  * malformed input raises ``ValueError``;
  * the module imports with jax, flax and msgpack blocked (a subprocess).
Inputs are made with numpy from seeds.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from video_classification_tpu_torch.utils import flax_msgpack
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "params": {
            "conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32),
                     "bias": rng.randn(8).astype(np.float32)},
            "ids": rng.randint(-2 ** 31, 2 ** 31 - 1, (5, 7)).astype(np.int32),
            "pixels": rng.randint(0, 256, (4, 6, 3)).astype(np.uint8),
            "mask": rng.rand(9) > 0.5,
            "empty": {},
            "zero_size": np.zeros((0, 3), np.float32),
        },
        "scalars": {"f32": np.float32(1.5), "i64": np.int64(-7), "py_int": 300,
                    "py_float": 0.25, "flag": True, "none": None, "text": "ok",
                    "blob": b"\x00\x01", "z": complex(1.5, -2.0)},
        "seq": [np.arange(3, dtype=np.int32), {"a": np.float32(2.0)}],
        "tup": (1, -40, 70000),
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape and got.flags.writeable
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, (got, want)


def test_from_bytes_reads_flax_trees():
    tree = _tree(0)
    data = serialization.to_bytes(tree)
    _assert_same(flax_msgpack.from_bytes(data), serialization.msgpack_restore(data))


def test_bfloat16_leaves_become_torch_bfloat16():
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    data = serialization.to_bytes({"w": jnp.asarray(x, jnp.bfloat16),
                                   "s": jnp.bfloat16(0.5)})
    got = flax_msgpack.from_bytes(data)
    assert got["w"].dtype == torch.bfloat16 and tuple(got["w"].shape) == (4, 5)
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy().view(np.uint16), want)
    assert got["s"].dtype == torch.bfloat16 and float(got["s"]) == 0.5
    # Written back under the same dtype name, byte for byte, from torch or
    # from jax's numpy bfloat16.
    assert flax_msgpack.to_bytes({"w": got["w"], "s": got["s"]}) == data
    numpy_bf16 = {"w": np.asarray(jnp.asarray(x, jnp.bfloat16))}
    assert flax_msgpack.to_bytes(numpy_bf16) == serialization.to_bytes(numpy_bf16)


def test_to_bytes_is_byte_equal_to_flax():
    for seed in range(3):
        tree = _tree(seed)
        assert flax_msgpack.to_bytes(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63,
    "", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 65536, "é",
    b"", b"y" * 256, b"y" * 65536, 1e300, -0.0, float("inf"),
    [], list(range(15)), list(range(16)), list(range(70000)),
])
def test_every_length_form_matches_flax(value):
    """Python values through flax (a list becomes a map keyed by index);
    msgpack's own arrays, which flax writes only inside an ext, are read in
    all three length forms."""
    tree = {"v": value}
    data = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == data
    _assert_same(flax_msgpack.from_bytes(data), serialization.msgpack_restore(data))
    if isinstance(value, list):
        assert flax_msgpack.from_bytes(msgpack.packb(tree))["v"] == value


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 7, 64, 300, 70000])
def test_ext_length_forms_match_flax(n):
    """fixext 1-16, ext 8, 16 and 32: the payload of a uint8 array of n
    elements crosses each form."""
    tree = {"a": np.arange(n, dtype=np.uint8)}
    data = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == data
    _assert_same(flax_msgpack.from_bytes(data), tree)


def test_chunked_arrays_are_joined(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(2)
    tree = {"big": rng.randn(10, 7).astype(np.float32),   # 280 bytes: 5 chunks
            "small": rng.randn(3).astype(np.float32),
            "nested": {"big_i8": rng.randint(-128, 128, (3, 50)).astype(np.int8)}}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert flax_msgpack.to_bytes(tree) == data
    _assert_same(flax_msgpack.from_bytes(data), tree)
    bf = {"w": jnp.asarray(rng.randn(6, 9), jnp.bfloat16)}
    data = serialization.to_bytes(bf)
    got = flax_msgpack.from_bytes(data)["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (6, 9)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(bf["w"]).view(np.uint16))
    assert flax_msgpack.to_bytes({"w": got}) == data


@pytest.mark.parametrize("data,match", [
    (b"", "starts with a map"),
    (msgpack.packb([1, 2]), "starts with a map"),
    (msgpack.packb({"a": msgpack.ExtType(9, b"xyz")}), "ext code 9"),
    (msgpack.packb({"a": 1})[:-1], "truncated"),
    (msgpack.packb({"a": 1}) + b"\x00", "bytes after"),
    (b"\x81\xa1a\xc1", "starts no msgpack value"),
])
def test_malformed_input_raises(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.from_bytes(data)


def test_unserializable_leaves_raise():
    with pytest.raises(TypeError):
        flax_msgpack.to_bytes({"a": object()})
    with pytest.raises(ValueError):
        flax_msgpack.to_bytes({"a": np.array([object()])})


def test_module_imports_with_jax_flax_and_msgpack_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from video_classification_tpu_torch.utils import flax_msgpack as f\n"
        "t = {'a': np.arange(6, dtype=np.float32).reshape(2, 3), 'b': {'c': np.int32(4)}}\n"
        "g = f.from_bytes(f.to_bytes(t))\n"
        "assert (g['a'] == t['a']).all() and g['b']['c'] == 4\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
