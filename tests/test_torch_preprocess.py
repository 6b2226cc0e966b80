"""The port's preprocessing (data/preprocess.py) against the JAX package's
`preprocess_folder`, on the CPU, on the same folder of wav files: two
violin notes of the synthetic corpus, one written at the config's 16 kHz,
the other at 44.1 kHz (resampled on load), each padded to whole chunks of
16384 samples, with `pitch_tracker: yin`, and then with the two CREPE
trackers.

Tolerances, per cache file:
  * signals.npy: within 1e-4 of the peak (the resampled file: scipy filters
    float32 input in float32, the port in float64);
  * pitchs.npy: 1e-3 relative;
  * loudness.npy: 1e-3 absolute;
  * mfccs.npy: 1e-3 of the peak.
"""

import os

import numpy as np
import pytest

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.data.preprocess import preprocess_folder as jax_preprocess_folder
from ddsp_pytorch_tpu_torch import preprocess as preprocess_cli
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import make_synthetic_dataset
from ddsp_pytorch_tpu_torch.data.preprocess import get_files, make_pitch_fn, preprocess_folder
from ddsp_pytorch_tpu_torch.utils import resample_poly, save_wav

SR, BLOCK, LENGTH = 16000, 256, 16384
SIGNAL_REL_OF_PEAK, PITCH_RTOL, LOUDNESS_ATOL, MFCC_REL_OF_PEAK = 1e-4, 1e-3, 1e-3, 1e-3


def _raw(data_location, out_dir, tracker="yin"):
    return {
        "data": {"data_location": str(data_location), "extension": "wav"},
        "preprocess": {"sample_rate": SR, "block_size": BLOCK, "signal_length": LENGTH,
                       "out_dir": str(out_dir), "pitch_tracker": tracker, "mfcc_ref_db": 0.0},
    }


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """data/{train,validation}/*.wav: violin notes 1.5 s long, the second
    file of each partition at 44.1 kHz."""
    root = tmp_path_factory.mktemp("preprocess")
    notes = make_synthetic_dataset(str(root / "notes"), n_items=2, sample_rate=SR, signal_length=24000,
                                   block_size=BLOCK, n_harmonic=8, instrument="violin", seed=2,
                                   partitions=("train",), device="cpu")["signals"]
    for part in ("train", "validation"):
        os.makedirs(root / "data" / part)
        save_wav(str(root / "data" / part / "a.wav"), notes[0], SR)
        save_wav(str(root / "data" / part / "b.wav"), resample_poly(notes[1], 441, 160), 44100)
    return root


def test_preprocess_folder_matches_jax(folder):
    data = folder / "data"
    assert [f.name for f in get_files(data / "train")] == ["a.wav", "b.wav"]
    for part in ("train", "validation"):
        preprocess_folder(data, part, Config.from_dict(_raw(data, folder / "port")), device="cpu")
        jax_preprocess_folder(data, part, JaxConfig.from_dict(_raw(data, folder / "jax")))
        got = {n: np.load(folder / "port" / part / f"{n}.npy") for n in ("signals", "pitchs", "loudness", "mfccs")}
        want = {n: np.load(folder / "jax" / part / f"{n}.npy") for n in got}
        # 1.5 s at 16 kHz pads to 2 chunks; at 44.1 kHz, resampled, too
        assert got["signals"].shape == want["signals"].shape == (4, LENGTH)
        assert got["pitchs"].shape == want["pitchs"].shape == (4, LENGTH // BLOCK)
        assert got["mfccs"].shape == want["mfccs"].shape == (4, LENGTH // BLOCK + 1, 30)
        for n in got:
            assert got[n].dtype == want[n].dtype == np.float32, n
        peak = float(np.abs(want["signals"]).max())
        assert float(np.abs(got["signals"] - want["signals"]).max()) <= SIGNAL_REL_OF_PEAK * peak
        np.testing.assert_allclose(got["pitchs"], want["pitchs"], rtol=PITCH_RTOL)
        np.testing.assert_allclose(got["loudness"], want["loudness"], atol=LOUDNESS_ATOL)
        mf_peak = float(np.abs(want["mfccs"]).max())
        assert float(np.abs(got["mfccs"] - want["mfccs"]).max()) <= MFCC_REL_OF_PEAK * mf_peak


def test_cli_writes_the_cache(folder, tmp_path):
    data = folder / "data"
    cfg = Config.from_dict(_raw(data, tmp_path / "unused"))
    cfg.to_yaml(str(tmp_path / "cfg.yaml"))
    preprocess_cli.main(["--config", str(tmp_path / "cfg.yaml"), "--partition", "train",
                         "--set", f"preprocess.out_dir={tmp_path / 'cli'}", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "cli" / "train")) == ["loudness.npy", "mfccs.npy", "pitchs.npy",
                                                              "signals.npy"]
    assert not os.path.exists(tmp_path / "cli" / "validation")


@pytest.mark.parametrize("tracker", ["hybrid", "crepe"])
def test_crepe_trackers_match_jax(folder, tracker):
    """The CREPE trackers (the shipped pretrained/crepe_tiny.msgpack) run
    in the port's preprocessing, all of a file's chunks in one batched
    call, and give the JAX package's pitch (1e-3 relative, as above)."""
    data = folder / "data"
    preprocess_folder(data, "train", Config.from_dict(_raw(data, folder / f"port_{tracker}", tracker)), device="cpu")
    jax_preprocess_folder(data, "train", JaxConfig.from_dict(_raw(data, folder / f"jax_{tracker}", tracker)))
    got = np.load(folder / f"port_{tracker}" / "train" / "pitchs.npy")
    want = np.load(folder / f"jax_{tracker}" / "train" / "pitchs.npy")
    assert got.shape == want.shape == (4, LENGTH // BLOCK) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=PITCH_RTOL)
    assert callable(make_pitch_fn(Config.from_dict(_raw(data, folder / "x", tracker)), device="cpu"))


def test_unknown_tracker_and_missing_partition(folder):
    with pytest.raises(ValueError, match="unknown pitch_tracker"):
        make_pitch_fn(Config.from_dict(_raw(folder / "data", folder / "x", "sigmund")), device="cpu")
    with pytest.raises(FileNotFoundError):
        preprocess_folder(folder / "data", "test", Config.from_dict(_raw(folder / "data", folder / "x")),
                          device="cpu")
