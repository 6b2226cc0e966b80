"""The port's config and its YAML-subset reader against the JAX package's
Config and PyYAML's safe_load.  Exact equality throughout: both sides
parse the same text into Python scalars."""

import glob
import math
import os

import pytest
import torch
import yaml

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu_torch.config import Config, dump_yaml, load_yaml

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "configs", "*.yaml"))
    + glob.glob(os.path.join(REPO, "pretrained", "*_config.yaml"))
)


def test_every_config_file_is_found():
    assert "configs/config.yaml" in YAML_FILES
    assert len(YAML_FILES) >= 10


@pytest.mark.parametrize("path", YAML_FILES)
def test_reader_matches_safe_load(path):
    text = open(os.path.join(REPO, path)).read()
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", YAML_FILES)
def test_config_matches_jax_config(path):
    full = os.path.join(REPO, path)
    want = JaxConfig.from_yaml(full).to_dict()
    got = Config.from_yaml(full).to_dict()
    # TrainConfig fields are the same on both sides
    assert got == want


def test_writer_round_trips_through_both_readers(tmp_path):
    cfg = Config.from_yaml(os.path.join(REPO, "configs", "config.yaml"))
    cfg.data.mean_loudness, cfg.data.std_loudness = -7.924359798431396, 0.5472896695137024
    cfg.train.lr = 1e-5  # repr '1e-05' is a string to YAML 1.1 unless written with a dot
    cfg.train.grad_clip_norm = float("inf")
    path = str(tmp_path / "frozen.yaml")
    cfg.to_yaml(path)
    text = open(path).read()
    assert load_yaml(text) == yaml.safe_load(text) == cfg.to_dict()
    assert Config.from_yaml(path) == cfg
    assert JaxConfig.from_yaml(path).to_dict()["train"]["lr"] == 1e-5


@pytest.mark.parametrize(
    "text,value",
    [
        ("1e-3", "1e-3"),
        ("1.0e-3", 1.0e-3),
        ("yes", True),
        ("Off", False),
        ("~", None),
        ("-.inf", -math.inf),
        ("'it''s'", "it's"),
        ('"a: b # c"', "a: b # c"),
        ("[512, 256]", [512, 256]),
        ("[]", []),
        ("a#b", "a#b"),
        ("7 # comment", 7),
        ("1_000", 1000),
    ],
)
def test_scalars_resolve_like_safe_load(text, value):
    assert load_yaml(f"k: {text}") == {"k": value} == yaml.safe_load(f"k: {text}")


@pytest.mark.parametrize(
    "text",
    [
        "k: 0x1F",
        "k: 012",
        "k: &anchor 1",
        "k: |\n  block",
        "k: {a: 1}",
        "---\nk: 1",
        "k:\n  - a: 1",
        "k: [[1], 2]",
        "k: a: b",
    ],
    ids=["hex", "octal", "anchor", "block-scalar", "flow-map", "document", "seq-of-maps",
         "nested-flow", "colon"],
)
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError, match="subset"):
        load_yaml(text)


def test_block_sequence_and_nesting():
    text = "a:\n  b:\n    c: 1\n  d:\n  - 4096\n  - x\ne: null\n"
    assert load_yaml(text) == yaml.safe_load(text) == {"a": {"b": {"c": 1}, "d": [4096, "x"]}, "e": None}
    assert load_yaml(dump_yaml(load_yaml(text))) == load_yaml(text)


@pytest.mark.parametrize(
    "overrides",
    [
        ["train.lr=3e-4", "train.scales=[512,256]", "model.kwargs.hidden_size=64"],
        ["train.grad_clip_norm=1.0", "data.mean_loudness=-8", "train.optimizer=sgd"],
        ["model.kwargs.new_key=true", "train.lr_stop=null"],
    ],
)
def test_apply_overrides_matches_jax(overrides):
    path = os.path.join(REPO, "configs", "config.yaml")
    want = JaxConfig.from_yaml(path).apply_overrides(overrides).to_dict()
    got = Config.from_yaml(path).apply_overrides(overrides).to_dict()
    assert got == want


@pytest.mark.parametrize("bad", ["train.nope=1", "nosection.x=1", "train.lr"])
def test_apply_overrides_rejects_unknown_paths(bad):
    with pytest.raises(ValueError):
        Config().apply_overrides([bad])


def test_n_frames():
    cfg = Config.from_yaml(os.path.join(REPO, "configs", "config.yaml"))
    assert cfg.n_frames == 375 == JaxConfig.from_yaml(os.path.join(REPO, "configs", "config.yaml")).n_frames
