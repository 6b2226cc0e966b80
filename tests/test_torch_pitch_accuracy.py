"""The port's pitch-accuracy scoring and hybrid sweep
(ddsp_pytorch_tpu_torch/pitch_accuracy.py, tune_hybrid_pitch.py) against
scripts/pitch_accuracy.py and scripts/tune_hybrid_pitch.py, on the CPU.

Tolerances: on the same corpus (or the same cache) every tracker's RPA
equals the JAX script's exactly (the frames counted are the same, and the
trackers agree to ~1e-6 relative, far inside the 50-cent threshold), and
each mean and median |cents| within 0.01 cents.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ddsp_pytorch_tpu.data import fixtures as J
from ddsp_pytorch_tpu.models import crepe as JC
from ddsp_pytorch_tpu_torch import pitch_accuracy, tune_hybrid_pitch
from ddsp_pytorch_tpu_torch.data import fixtures as P
from ddsp_pytorch_tpu_torch.models.crepe import load_crepe
from ddsp_pytorch_tpu_torch.utils.audio_io import load_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CREPE = os.path.join(ROOT, "pretrained", "crepe_tiny.msgpack")
CENTS_ATOL = 1e-2
EVIDENCE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_scripts_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_summary(got: dict, want: dict):
    assert got.keys() == want.keys()
    assert got["n_frames"] == want["n_frames"]
    assert got["rpa"] == want["rpa"]
    for key in ("mean_abs_cents", "median_abs_cents"):
        assert abs(got[key] - want[key]) <= CENTS_ATOL, (key, got[key], want[key])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("oof"))
    P.make_oof_corpus(root, sample_rate=16000, note_seconds=0.5, n_train=0, n_validation=3, seed=0)
    return root


@pytest.mark.parametrize("pitch_range", [None, (50.0, 2000.0)], ids=["tracker-defaults", "shipped-range"])
def test_score_corpus_matches_jax(corpus, pitch_range):
    want = _script("pitch_accuracy").score_corpus(corpus, 256, crepe_bundle=CREPE, pitch_range=pitch_range)
    got = pitch_accuracy.score_corpus(corpus, 256, crepe_bundle=CREPE, pitch_range=pitch_range, device="cpu")
    assert {k: v for k, v in got.items() if k not in ("summary", "per_file")} == \
        {k: v for k, v in want.items() if k not in ("summary", "per_file")}
    assert set(got["summary"]) == set(want["summary"]) == {"yin", "crepe", "hybrid"}
    for tracker, summary in want["summary"].items():
        _same_summary(got["summary"][tracker]["overall"], summary["overall"])
        assert got["summary"][tracker]["families"].keys() == summary["families"].keys()
        for fam, s in summary["families"].items():
            _same_summary(got["summary"][tracker]["families"][fam], s)
    assert len(got["per_file"]) == len(want["per_file"]) == 9
    for g, w in zip(got["per_file"], want["per_file"]):
        assert (g["file"], g["tracker"], g["family"]) == (w["file"], w["tracker"], w["family"])
        _same_summary({k: g[k] for k in ("rpa", "mean_abs_cents", "median_abs_cents", "n_frames")},
                      {k: w[k] for k in ("rpa", "mean_abs_cents", "median_abs_cents", "n_frames")})


def test_cli_writes_the_artifact_layout(corpus, tmp_path):
    out = tmp_path / "pa.json"
    report = pitch_accuracy.main(["--device", "cpu", "--corpus", corpus, "--crepe", "", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(report))
    with open(os.path.join(ROOT, "pretrained", "pitch_accuracy.json")) as f:
        artifact = json.load(f)
    assert saved.keys() == artifact.keys()
    assert saved["summary"]["yin"].keys() == artifact["summary"]["yin"].keys()
    assert saved["per_file"][0].keys() == artifact["per_file"][0].keys()
    assert set(saved["summary"]) == {"yin"}


def test_robustness_report_matches_jax_yin_only():
    want = _script("pitch_accuracy").robustness_report(16000, 256, None, "tiny", n_validation=1)
    got = pitch_accuracy.robustness_report(16000, 256, None, "tiny", n_validation=1, device="cpu")
    with open(os.path.join(ROOT, "pretrained", "pitch_robustness.json")) as f:
        artifact = json.load(f)
    assert got.keys() == want.keys() == artifact.keys() - {"pitch_range"}
    for bucket in ("conditions", "extremes"):
        assert got[bucket].keys() == want[bucket].keys() == artifact[bucket].keys()
        for tag, trackers in want[bucket].items():
            _same_summary(got[bucket][tag]["yin"]["overall"], trackers["yin"]["overall"])


def test_sweep_on_a_one_file_cache_matches_jax(tmp_path):
    model = load_crepe(CREPE, device="cpu")
    cache = str(tmp_path / "cache")
    conds = [c for c in tune_hybrid_pitch.conditions() if c[0] == "snr10"]
    tune_hybrid_pitch.build_cache(cache, 16000, 256, 1, model, conds, device="cpu")
    combos = [(f"y{w}_s{s}", dict(yin_weight=w, switch_per_octave=s, salience_floor=0.03, confidence_gate=2.0))
              for w in (4.0, 8.0) for s in (10.0, 60.0)]
    got = tune_hybrid_pitch.sweep(cache, 16000, 256, combos, device="cpu")
    want = _script("tune_hybrid_pitch").sweep(cache, 16000, 256, combos)
    assert got == want
    assert set(got["snr10"]) == {"yin", "crepe", *[label for label, _ in combos]}
    # the cached evidence is the JAX function's on the same file
    (stem,) = [f[:-4] for f in os.listdir(os.path.join(cache, "snr10")) if f.endswith(".npz")]
    z = np.load(os.path.join(cache, "snr10", stem + ".npz"))
    sig, _ = load_wav(os.path.join(cache, "snr10", "corpus", "validation", stem + ".wav"), 16000)
    with open(CREPE, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    sal, d16, hop = JC.hybrid_evidence(jnp.asarray(sig), 16000, 256, params, "tiny")
    assert int(z["hop"]) == hop
    np.testing.assert_allclose(z["salience"], np.asarray(sal), atol=EVIDENCE_ATOL, rtol=0)
    np.testing.assert_allclose(z["d16"], np.asarray(d16), atol=EVIDENCE_ATOL, rtol=0)
    f0f, vf = J.frame_truth(*[np.load(os.path.join(cache, "snr10", "corpus", "truth", "validation",
                                                   stem + ".npz"))[k] for k in ("f0", "voiced")],
                            256, int(z["n_out"]))
    np.testing.assert_array_equal(z["f0f"], f0f)
    np.testing.assert_array_equal(z["vf"], vf)


def test_default_combos_hold_the_shipped_defaults():
    combos = dict(tune_hybrid_pitch.default_combos())
    assert len(combos) == 36
    assert dict(yin_weight=8.0, switch_per_octave=60.0, salience_floor=0.03, confidence_gate=2.0) \
        in combos.values()
