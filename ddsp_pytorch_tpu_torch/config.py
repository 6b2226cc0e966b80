"""Typed configuration, and a reader and writer for the YAML it is kept in.

Port of ddsp_pytorch_tpu/config.py:22-268: the same sections and fields
(`data`, `preprocess`, `model`, `train`, `mesh`), `from_dict`/`to_dict`,
`apply_overrides` and `n_frames`.  The port may not import PyYAML, so
`load_yaml`/`dump_yaml` handle the subset of YAML that `configs/*.yaml`
and the frozen run configs use: nested block mappings, block sequences and
`[a, b]` flow lists of scalars, plain and quoted scalars resolved as
PyYAML's `safe_load` resolves them (YAML 1.1: `1.0e-3` is a float, `1e-3`
a string), and `#` comments.  Anything else raises `ValueError`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# --------------------------------------------------------------- YAML subset

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's YAML 1.1 resolvers, less the forms outside the subset
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# octal, hex, binary and sexagesimal numbers resolve to numbers in YAML 1.1
_OTHER_NUMBER = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$"
)
_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _unsupported(lineno: int, what: str):
    return ValueError(f"YAML line {lineno}: {what} is outside the supported subset")


def _strip_comment(text: str) -> str:
    """Drop a `#` comment (at the start or after whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "\"'" and (i == 0 or text[i - 1] in " \t[,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str, lineno: int = 0):
    """A plain, quoted or `[a, b]` flow-list scalar → Python value."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise _unsupported(lineno, f"flow list {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items, quote, start = [], None, 0
        for i, ch in enumerate(inner):
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "\"'":
                quote = ch
            elif ch in "[{":
                raise _unsupported(lineno, "a nested flow collection")
            elif ch == ",":
                items.append(inner[start:i])
                start = i + 1
        items.append(inner[start:])
        return [_scalar(item, lineno) for item in items]
    if text.startswith('"'):
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            raise _unsupported(lineno, f"double-quoted scalar {text!r}") from None
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'"):
            raise _unsupported(lineno, f"single-quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] in ("{", "&", "*", "!", "|", ">", "%", "@", "`") or ": " in text:
        raise _unsupported(lineno, f"scalar {text!r}")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    if _OTHER_NUMBER.match(text):
        raise _unsupported(lineno, f"number {text!r}")
    return text


def _split_key(content: str, lineno: int):
    """`key: value` or `key:` → (key, value text)."""
    if content.endswith(":"):
        key, rest = content[:-1], ""
    elif ": " in content:
        key, rest = content.split(": ", 1)
    else:
        raise _unsupported(lineno, f"line {content!r}")
    key = key.strip()
    if key.startswith(("'", '"')):
        key = _scalar(key, lineno)
    elif not key or key.startswith(("-", "?", "[", "{")):
        raise _unsupported(lineno, f"key {key!r}")
    return key, rest.strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, i: int, indent: int):
    """Parse the block mapping or sequence whose lines start at `indent`."""
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            _, content, lineno = lines[i]
            item = content[1:].strip()
            if not item or (": " in item or item.endswith(":")) and not item.startswith(("'", '"', "[")):
                raise _unsupported(lineno, "a sequence of collections")
            out.append(_scalar(item, lineno))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        _, content, lineno = lines[i]
        if _is_item(content):
            raise _unsupported(lineno, "a sequence item inside a mapping")
        key, rest = _split_key(content, lineno)
        if key in out:
            raise ValueError(f"YAML line {lineno}: duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = _scalar(rest, lineno)
        elif i < len(lines) and (
            lines[i][0] > indent or (lines[i][0] == indent and _is_item(lines[i][1]))
        ):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"YAML line {lines[i][2]}: unexpected indentation")
    return out, i


def load_yaml(text: str):
    """Parse YAML text of the supported subset (see module docstring)."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if raw.startswith(("---", "...", "%")):
            raise _unsupported(lineno, "a document marker or directive")
        content = _strip_comment(raw)
        if not content.strip():
            continue
        stripped = content.lstrip(" ")
        if stripped.startswith("\t") or "\t" in content[: len(content) - len(stripped)]:
            raise _unsupported(lineno, "tab indentation")
        lines.append((len(content) - len(stripped), stripped, lineno))
    if not lines:
        return None
    if len(lines) == 1 and not _is_item(lines[0][1]) and ": " not in lines[0][1] \
            and not lines[0][1].endswith(":"):
        return _scalar(lines[0][1], lines[0][2])
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"YAML line {lines[i][2]}: unexpected indentation")
    return value


def _dump_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, e, exponent = text.partition("e")
        if "." not in mantissa:  # YAML 1.1 reads '1e-05' as a string
            mantissa += ".0"
        return mantissa + e + exponent
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(v) for v in value) + "]"
    raise TypeError(f"cannot write {type(value).__name__} to YAML")


def dump_yaml(tree: dict, indent: int = 0) -> str:
    """Write a nested dict of scalars and lists of scalars as block YAML that
    `load_yaml` (and PyYAML) read back to the same values."""
    out = []
    for key, value in tree.items():
        name = key if isinstance(key, str) and _PLAIN_KEY.match(key) else json.dumps(str(key))
        if isinstance(value, dict) and value:
            out.append(" " * indent + f"{name}:\n" + dump_yaml(value, indent + 2))
        elif isinstance(value, dict):
            raise TypeError(f"cannot write the empty mapping {name!r}")
        else:
            out.append(" " * indent + f"{name}: {_dump_scalar(value)}\n")
    return "".join(out)


# -------------------------------------------------------------- the sections


@dataclass
class DataConfig:
    """`data:` section (config.py:22-33)."""

    data_location: str = "./data"
    extension: str = "wav"
    mean_loudness: Optional[float] = None
    std_loudness: Optional[float] = None


@dataclass
class PreprocessConfig:
    """`preprocess:` section (config.py:36-81); the feature-extraction
    fields are kept for config parity, the port does not preprocess yet."""

    sample_rate: int = 48000
    signal_length: int = 192000
    block_size: int = 512
    oneshot: bool = False
    out_dir: str = "./cache"
    n_mfcc: int = 30
    mfcc_n_fft: int = 1024
    mfcc_fmin: float = 20.0
    mfcc_fmax: float = 8000.0
    n_mels: int = 128
    mfcc_ref_db: Optional[float] = None
    loudness_n_fft: int = 2048
    pitch_fmin: float = 50.0
    pitch_fmax: float = 2000.0
    pitch_tracker: str = "hybrid"
    crepe_params: Optional[str] = None
    crepe_capacity: str = "tiny"


@dataclass
class ModelConfig:
    """`model:` section (config.py:84-98): registry name + kwargs."""

    name: str = "single-inst-decoder"
    kwargs: Dict[str, Any] = field(
        default_factory=lambda: {
            "hidden_size": 512,
            "n_harmonic": 64,
            "n_bands": 65,
            "sample_rate": 48000,
            "block_size": 512,
            "has_reverb": True,
        }
    )


@dataclass
class TrainConfig:
    """`train:` section (config.py:101-151)."""

    scales: List[int] = field(default_factory=lambda: [4096, 2048, 1024, 512, 256, 128])
    overlap: float = 0.75
    batch: int = 16
    lr: float = 1.0e-3
    steps: int = 500000
    optimizer: str = "adam"  # or "sgd"
    seed: int = 0
    val_interval_epochs: int = 10
    log_interval_epochs: int = 1
    checkpoint_every_steps: int = 2000
    keep_checkpoints: int = 3
    metrics_flush_steps: int = 20
    grad_clip_norm: Optional[float] = None
    lr_stop: Optional[float] = None
    lr_decay_steps: Optional[int] = None
    steps_per_call: int = 1  # the port runs 1 (ROADMAP.md)
    scan_unroll: int = 1


@dataclass
class MeshConfig:
    """`mesh:` section (config.py:154-166).  Parsed; the port trains on one
    device, so the Trainer refuses time > 1 and data > 1."""

    data: int = -1
    time: int = 1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        """Build from a raw YAML dict; unknown keys in each section are
        ignored, so the reference's configs load as they are."""

        def build(dc_cls, section):
            if section is None:
                return dc_cls()
            names = {f.name for f in dataclasses.fields(dc_cls)}
            return dc_cls(**{k: v for k, v in section.items() if k in names})

        return cls(
            data=build(DataConfig, raw.get("data")),
            preprocess=build(PreprocessConfig, raw.get("preprocess")),
            model=build(ModelConfig, raw.get("model")),
            train=build(TrainConfig, raw.get("train")),
            mesh=build(MeshConfig, raw.get("mesh")),
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        with open(path, "r") as f:
            raw = load_yaml(f.read())
        return cls.from_dict(raw or {})

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(dump_yaml(self.to_dict()))

    def apply_overrides(self, overrides: List[str]) -> "Config":
        """Override fields from `key.path=value` strings (config.py:187-257):
        the path is dotted through the sections and into plain dicts, the
        value is read as a YAML scalar (plus the plain scientific form
        `1e-4`).  Unknown paths raise.  Mutates and returns self."""
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"--set expects key.path=value, got {item!r}")
            path, _, raw_val = item.partition("=")
            value = _scalar(raw_val) if raw_val != "" else None
            if isinstance(value, str):
                try:
                    value = float(value)
                except ValueError:
                    pass
            keys = path.strip().split(".")
            target: Any = self
            for i, key in enumerate(keys[:-1]):
                if isinstance(target, dict):
                    target = target.setdefault(key, {})
                elif dataclasses.is_dataclass(target) and key in {
                    f.name for f in dataclasses.fields(target)
                }:
                    target = getattr(target, key)
                else:
                    valid = (
                        sorted(target)
                        if isinstance(target, dict)
                        else sorted(f.name for f in dataclasses.fields(target))
                    )
                    raise ValueError(
                        f"--set {path}: no key {'.'.join(keys[:i + 1])!r}; valid here: {valid}"
                    )
            leaf = keys[-1]
            if isinstance(target, dict):
                target[leaf] = value
            elif dataclasses.is_dataclass(target) and leaf in {
                f.name for f in dataclasses.fields(target)
            }:
                setattr(target, leaf, value)
            else:
                valid = sorted(f.name for f in dataclasses.fields(target))
                raise ValueError(f"--set {path}: no field {leaf!r}; valid here: {valid}")
        return self

    @property
    def n_frames(self) -> int:
        return self.preprocess.signal_length // self.preprocess.block_size
