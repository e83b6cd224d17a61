"""The byte layout of flax's msgpack checkpoints, in Python and numpy.

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``:
stream checkpoints (``{'params', 'batch_stats'}``) and the sparse-fusion
checkpoint (``{'weight', 'bias'}``). This module reads and writes that layout
without flax or msgpack (neither is on the card's machine):

  * a tree is a msgpack map with str keys; flax stores a list or tuple as a
    map keyed "0", "1", ...;
  * ext 1 is an ndarray: the msgpack array [shape, dtype name, C-order
    buffer];
  * ext 2 is a Python complex: the msgpack array [real, imag];
  * ext 3 is a numpy scalar, stored as a 0-d ndarray;
  * an array above ``MAX_CHUNK_SIZE`` bytes is a map
    ``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``
    of flat pieces, which ``from_bytes`` joins again.

numpy has no bfloat16, so ``from_bytes`` hands a bfloat16 leaf to torch as a
``torch.bfloat16`` tensor over the stored 16-bit words; ``to_bytes`` writes a
``torch.bfloat16`` tensor back under that dtype name. ``to_bytes`` of a tree
of numpy arrays and Python scalars gives the bytes
``flax.serialization.to_bytes`` gives.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: the largest array leaf, in bytes, that is
# written as one ext (msgpack caps an object at 2**31 - 1 bytes).
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def is_map_header(byte: int) -> bool:
    """True when ``byte`` opens a msgpack map (fixmap, map 16, map 32), as
    the first byte of every flax checkpoint does."""
    return 0x80 <= byte <= 0x8F or byte in (0xDE, 0xDF)


# -- decoding -------------------------------------------------------------------


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# The length fields of bin, str, array, map and ext 8 / 16 / 32.
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
            0xC9: ">I"}


class _Reader:
    """A msgpack decoder over ``data``; ``views``: bin values as memoryviews
    of ``data`` (an array's buffer is then copied once, into the array)."""

    def __init__(self, data, views: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.views = views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, raw)
        if b in _FIXED:
            return _FIXED[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b not in _LENGTHS:
            raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack value")
        n = self.unpack(_LENGTHS[b])
        if b in (0xC4, 0xC5, 0xC6):
            data = self.take(n)
            return data if self.views else bytes(data)
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(n, raw)
        if b in (0xDC, 0xDD):
            return [self.value(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(n, raw)
        return self.ext(n)

    def text(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr if not isinstance(arr, np.ndarray) else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).value(raw=False)
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext code {code} (flax writes 1, 2 and 3)")


def _ndarray(data: memoryview):
    """ext 1's payload -> an aligned, writable numpy array (a torch.bfloat16
    tensor for bfloat16)."""
    shape, name, buf = _Reader(data, views=True).value(raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":
        words = np.frombuffer(buf, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node.get(_CHUNKED) is True:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if chunks and isinstance(chunks[0], torch.Tensor):  # bfloat16
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def from_bytes(data: bytes) -> Dict[str, Any]:
    """A flax msgpack checkpoint -> its tree: nested dicts of numpy arrays
    (``torch.bfloat16`` tensors for bfloat16 leaves), numpy scalars and
    Python values. Raises ``ValueError`` on a root that is not a map, an
    unknown ext code, truncated data or trailing bytes."""
    if not data or not is_map_header(data[0]):
        raise ValueError("a flax msgpack checkpoint starts with a map")
    reader = _Reader(data)
    tree = reader.value(raw=False)
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack map")
    return _unchunk(tree)


# -- encoding -------------------------------------------------------------------


def _length(n: int, small: int, fix: int, codes: Tuple[int, int, int]) -> bytes:
    """The header of a str / bin / array / map / ext of ``n`` items or
    bytes: a fix form below ``small`` (fix < 0: none), else 8-, 16- or 32-bit
    lengths (``codes``; 0 for a width the type lacks)."""
    if n < small and fix >= 0:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    forms = ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"), (0, 0xFFFFFFFF, 0xCE, ">I"),
             (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")) if v >= 0 else (
        (-0x80, -1, 0xD0, ">b"), (-0x8000, -1, 0xD1, ">h"),
        (-0x80000000, -1, 0xD2, ">i"), (-0x8000000000000000, -1, 0xD3, ">q"))
    for lo, hi, code, fmt in forms:
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit in 64 bits")


def _ext(code: int, payload: List, out: List) -> None:
    """An ext of ``payload`` (a list of byte strings) onto ``out``."""
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = sum(len(part) for part in payload)
    out.append(bytes([fixed[n]]) if n in fixed else _length(n, 0, -1, (0xC7, 0xC8, 0xC9)))
    out.append(struct.pack(">b", code))
    out.extend(payload)


def _array_payload(arr: Any) -> List:
    """ext 1's payload of a numpy array or a torch.bfloat16 tensor: the
    msgpack array [shape, dtype name, C-order buffer], the buffer not
    copied."""
    if isinstance(arr, np.ndarray):
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialized")
        shape, name = arr.shape, arr.dtype.name
    else:
        shape, name = tuple(arr.shape), "bfloat16"
        arr = arr.detach().cpu().contiguous().view(torch.int16).numpy()
    buf = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    payload = [b"\x93"]
    _pack(list(shape), payload)
    _pack(name, payload)
    payload += [_length(len(buf), 0, -1, (0xC4, 0xC5, 0xC6)), buf]
    return payload


def _is_bfloat16_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16


def _chunk(arr: Any) -> Dict[str, Any]:
    itemsize = arr.dtype.itemsize if isinstance(arr, np.ndarray) else 2
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + step]
                       for i, s in enumerate(range(0, n, step))}}


def _nbytes(arr: Any) -> int:
    if isinstance(arr, np.ndarray):
        return arr.size * arr.dtype.itemsize
    return arr.numel() * 2


def _pack(v: Any, out: List) -> None:
    """One value onto ``out`` in msgpack's own choice of forms
    (``msgpack.packb`` with ``use_bin_type=True``)."""
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif type(v) is int:
        out.append(_int(v))
    elif type(v) is float:
        out.append(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        data = v.encode("utf-8")
        out += [_length(len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB)), data]
    elif type(v) is bytes:
        out += [_length(len(v), 0, -1, (0xC4, 0xC5, 0xC6)), v]
    elif type(v) in (list, tuple):
        out.append(_length(len(v), 16, 0x90, (0, 0xDC, 0xDD)))
        for x in v:
            _pack(x, out)
    elif type(v) is dict:
        out.append(_length(len(v), 16, 0x80, (0, 0xDE, 0xDF)))
        for k, x in v.items():
            _pack(k, out)
            _pack(x, out)
    elif isinstance(v, np.ndarray) or _is_bfloat16_tensor(v):
        _ext(_EXT_NDARRAY, _array_payload(v), out)
    elif isinstance(v, np.generic):
        _ext(_EXT_NPSCALAR, _array_payload(np.asarray(v)), out)
    elif type(v) is complex:
        payload: List = []
        _pack([v.real, v.imag], payload)
        _ext(_EXT_COMPLEX, payload, out)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def _state_dict(node: Any) -> Any:
    """flax's ``to_state_dict`` of dicts, lists and tuples (str keys; a
    sequence becomes a map keyed by its indices), with array leaves above
    ``MAX_CHUNK_SIZE`` bytes chunked."""
    if isinstance(node, dict):
        keys = [str(k) for k in node]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys without unique str forms: {list(node)}")
        return {str(k): _state_dict(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(node)}
    if (isinstance(node, np.ndarray) or _is_bfloat16_tensor(node)) and \
            _nbytes(node) > MAX_CHUNK_SIZE:
        return _chunk(node)
    return node


def to_bytes(tree: Any) -> bytes:
    """A tree of dicts, lists, numpy arrays (or ``torch.bfloat16`` tensors),
    numpy scalars and Python scalars -> the bytes of
    ``flax.serialization.to_bytes`` of the same tree."""
    out: List = []
    _pack(_state_dict(tree), out)
    return b"".join(out)
