"""Exported-bundle reader: flax msgpack params + meta.json, stdlib only.

A bundle directory (written by ddsp_pytorch_tpu/export/__init__.py:106-124)
holds `params.msgpack` (flax.serialization.msgpack_serialize of the param
tree), `config.yaml` and `meta.json`.  `meta.json` carries everything
serving needs (model name and kwargs, loudness stats, sample rate, block
size), so this module reads it and never touches the YAML.

flax's msgpack format is plain MessagePack plus two extension types:
  ext 1  ndarray:       payload = msgpack (shape, dtype name, C-order bytes)
  ext 3  numpy scalar:  the same payload, unwrapped to a 0-d value
(flax.serialization._msgpack_ext_pack).  The decoder below implements the
subset of MessagePack that format uses.
"""

from __future__ import annotations

import json
import os
import struct

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
