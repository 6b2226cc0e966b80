"""The port's bundle reader and its import isolation.

Every committed bundle's params.msgpack decodes bit-identically to
flax.serialization.msgpack_restore; meta.json gives the model; and the port
(and chip_smoke.py) import with jax, flax, msgpack, yaml and the JAX package
made unimportable.
"""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
from flax import serialization

from ddsp_pytorch_tpu_torch import bundle, weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLES = sorted(glob.glob(os.path.join(REPO, "pretrained", "ddsp_*_bundle")))
PORT = os.path.join(REPO, "ddsp_pytorch_tpu_torch")
PORT_MODULES = sorted(
    os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").replace(".__init__", "")
    for p in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
)
FORBIDDEN = ("jax", "flax", "msgpack", "yaml", "ddsp_pytorch_tpu")


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_eight_bundles_committed():
    assert len(BUNDLES) == 8


@pytest.mark.parametrize("bundle_dir", BUNDLES, ids=os.path.basename)
def test_params_decode_bit_identical_to_flax(bundle_dir):
    with open(os.path.join(bundle_dir, "params.msgpack"), "rb") as f:
        data = f.read()
    want = list(_leaves(serialization.msgpack_restore(data)))
    got = list(_leaves(bundle.msgpack_restore(data)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_meta_gives_model_kwargs():
    meta = bundle.read_meta(os.path.join(REPO, "pretrained", "ddsp_violin_bundle"))
    assert meta["model"]["name"] == "single-inst-decoder"
    assert meta["model"]["kwargs"] == {
        "block_size": 512,
        "has_reverb": True,
        "hidden_size": 512,
        "n_bands": 65,
        "n_harmonic": 64,
        "sample_rate": 48000,
    }
    assert meta["sample_rate"] == 48000 and meta["block_size"] == 512
    assert np.isfinite(meta["mean_loudness"]) and meta["std_loudness"] > 0


def test_msgpack_scalars_and_containers():
    """Hand-encoded MessagePack: the non-array types of the format."""
    data = bytes(
        [0x86]  # fixmap of 6
        + [0xA1, ord("a"), 0x05]  # "a": 5
        + [0xA1, ord("b"), 0xFF]  # "b": -1
        + [0xA1, ord("c"), 0xC0]  # "c": nil
        + [0xA1, ord("d"), 0xCB] + list(np.float64(1.5).byteswap().tobytes())
        + [0xA1, ord("e"), 0x92, 0xC3, 0xC2]  # [true, false]
        + [0xA1, ord("f"), 0xD1, 0xFF, 0x00]  # int16 -256
    )
    assert bundle.msgpack_restore(data) == {
        "a": 5, "b": -1, "c": None, "d": 1.5, "e": [True, False], "f": -256
    }


def test_flax_scalar_and_array_leaves():
    """ext 3 (numpy scalar) and ext 1 arrays of several dtypes and ranks,
    as flax.serialization writes them."""
    tree = {
        "s": np.float32(1.5),
        "i": np.int64(-3),
        "a": np.arange(6, dtype=np.int32).reshape(2, 3),
        "z": np.zeros((0, 4), np.float64),
        "n": {"k": np.float32([[1.0, 2.0]]), "name": "x", "lst": [1, 2]},
    }
    data = serialization.msgpack_serialize(tree)
    got = bundle.msgpack_restore(data)
    want = serialization.msgpack_restore(data)
    assert got["s"] == want["s"] and type(got["s"]) is type(want["s"])
    assert got["i"] == -3 and got["n"]["name"] == "x" and got["n"]["lst"] == [1, 2]
    for k in ("a", "z"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["n"]["k"], want["n"]["k"])


@pytest.mark.parametrize(
    "data",
    [bytes([0x92, 0x01]), bytes([0xC1]), bytes([0x01, 0x02])],
    ids=["truncated", "reserved-byte", "trailing-bytes"],
)
def test_msgpack_rejects_malformed(data):
    with pytest.raises(ValueError):
        bundle.msgpack_restore(data)


def test_state_dict_layout():
    tree = bundle.read_params(os.path.join(REPO, "pretrained", "ddsp_violin_bundle"))
    sd = weights.flax_to_state_dict(tree)
    np.testing.assert_array_equal(
        sd["decoder.f0_mlp.Dense_1.weight"].numpy(),
        tree["decoder"]["f0_mlp"]["Dense_1"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        sd["decoder.gru.weight_ih"].numpy(), tree["decoder"]["gru"]["w_ih"].T
    )
    np.testing.assert_array_equal(
        sd["decoder.out_mlp.LayerNorm_2.weight"].numpy(),
        tree["decoder"]["out_mlp"]["LayerNorm_2"]["scale"],
    )
    assert sd["reverb.decay"].shape == ()
    with pytest.raises(KeyError):
        weights.flax_to_state_dict({"x": {"mystery": np.zeros(1)}})


@pytest.mark.parametrize(
    "path",
    [os.path.relpath(p, REPO) for p in sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))]
    + ["chip_smoke.py"],
)
def test_no_forbidden_imports_in_source(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_port_imports_with_jax_stack_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {PORT_MODULES + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
