"""Exported bundles: flax msgpack params + meta.json, stdlib only.

A bundle directory (written by ddsp_pytorch_tpu/export/__init__.py:106-124)
holds `params.msgpack` (flax.serialization.msgpack_serialize of the param
tree), `config.yaml` and `meta.json`.  `meta.json` carries everything
serving needs (model name and kwargs, loudness stats, sample rate, block
size), so this module reads it and never touches the YAML.

flax's msgpack format is plain MessagePack plus two extension types:
  ext 1  ndarray:       payload = msgpack (shape, dtype name, C-order bytes)
  ext 3  numpy scalar:  the same payload, unwrapped to a 0-d value
(flax.serialization._msgpack_ext_pack).  The decoder below implements the
subset of MessagePack that format uses; the encoder writes the same bytes
as flax.serialization.msgpack_serialize (dict keys sorted, as its
jax.tree_util pass leaves them; msgpack-python's smallest encodings).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_CONST = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBER = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# type byte → (kind, struct format of its length)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


class _Reader:
    """Sequential MessagePack decoder over one bytes object."""

    def __init__(self, data: bytes, raw_str: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw_str else b.decode("utf-8")

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype_name, buf = _Reader(payload, raw_str=True).value()
        name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
        if name == "bfloat16":
            raise ValueError("msgpack: bfloat16 leaves are not supported")
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:  # positive fixint
            return t
        if t >= 0xE0:  # negative fixint
            return t - 0x100
        if t <= 0x8F:
            return self.map_(t & 0x0F)
        if t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if t <= 0xBF:
            return self.str_(t & 0x1F)
        if t in _CONST:
            return _CONST[t]
        if t in _NUMBER:
            return self.unpack(_NUMBER[t])
        if t in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[t])
        if t not in _SIZED:
            raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")
        kind, fmt = _SIZED[t]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.str_(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map_(n)
        return self.ext(self.unpack(">b"), n)

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes → nested dict of numpy arrays
    (the counterpart of flax.serialization.msgpack_restore)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the top-level value")
    return out


def _pack_sized(out: list, n: int, fix: Optional[int], fix_limit: int, codes) -> None:
    """Append a header for length `n`: the fix form below `fix_limit`, else
    the first of the sized forms `codes` (8-, 16-, 32-bit) that holds it."""
    if fix is not None and n < fix_limit:
        out.append(bytes([fix | n]))
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))
_BIN = ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))
_ARRAY = ((0xDC, ">H"), (0xDD, ">I"))
_MAP = ((0xDE, ">H"), (0xDF, ">I"))
_EXT = ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I"))
_FIXEXT_CODE = {n: code for code, n in _FIXEXT.items()}


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v > 0 else \
        ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        try:
            out.append(bytes([code]) + struct.pack(fmt, v))
            return
        except struct.error:
            continue
    raise ValueError(f"msgpack: integer {v} out of range")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's _ndarray_to_bytes: msgpack (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not supported")
    out: list = []
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return b"".join(out)


def _pack_ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    if n in _FIXEXT_CODE:
        out.append(bytes([_FIXEXT_CODE[n]]))
    else:
        _pack_sized(out, n, None, 0, _EXT)
    out.append(struct.pack(">b", code) + payload)


def _pack(out: list, obj) -> None:
    """Append obj's encoding, with exact types (msgpack's strict_types)."""
    kind = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif kind is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif kind is int:
        _pack_int(out, obj)
    elif kind is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif kind is str:
        data = obj.encode("utf-8")
        _pack_sized(out, len(data), 0xA0, 32, _STR)
        out.append(data)
    elif kind is bytes:
        _pack_sized(out, len(obj), None, 0, _BIN)
        out.append(obj)
    elif kind is list:
        _pack_sized(out, len(obj), 0x90, 16, _ARRAY)
        for item in obj:
            _pack(out, item)
    elif kind is dict:
        _pack_sized(out, len(obj), 0x80, 16, _MAP)
        for key in sorted(obj):
            _pack(out, key)
            _pack(out, obj[key])
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError(f"msgpack: cannot serialize {kind.__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode a nested dict of numpy arrays (and Python scalars) → flax
    msgpack bytes (the counterpart of flax.serialization.msgpack_serialize):
    an ndarray, 0-d included, as ext 1, a numpy scalar as ext 3."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)


def write_params(bundle_dir: str, tree: dict) -> None:
    """Write the bundle's params.msgpack from a flax-layout parameter tree."""
    with open(os.path.join(bundle_dir, "params.msgpack"), "wb") as f:
        f.write(msgpack_serialize(tree))


def read_params(bundle_dir: str) -> dict:
    """The bundle's parameter tree (nested dict of numpy arrays)."""
    with open(os.path.join(bundle_dir, "params.msgpack"), "rb") as f:
        return msgpack_restore(f.read())


def read_meta(bundle_dir: str) -> dict:
    """The bundle's meta.json: format tag, model name/kwargs, loudness
    stats, sample rate and block size."""
    with open(os.path.join(bundle_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "ddsp_pytorch_tpu.bundle.v1":
        raise ValueError(f"unknown bundle format {meta.get('format')!r}")
    return meta
