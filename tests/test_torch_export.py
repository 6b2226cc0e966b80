"""The port's export of a trained run, against the JAX package: its msgpack
writer against flax's, its wav writer against the JAX package's, and
bundles exported from runs the port trained (a single-inst-decoder and an
mfcc-autoencoder), served by the JAX package's `load_bundle`/
`make_streaming_synth`/`make_stream_session` and by the port's own stream.

Tolerances:
  * msgpack bytes and wav samples: equal;
  * the JAX stream of the port's bundle against the port's CPU stream of it,
    noise deterministic: 1e-4 absolute, the bound of
    tests/test_torch_streaming.py (the same f32 arithmetic from other
    libraries, carried over 8 GRU steps; for the autoencoder, its encoder's
    GRU and the causal MFCC front end too);
  * the impulse's dry tap: within 2e-2 of 1 (16-bit quantized,
    tests/test_export_runtime.py:167-176).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from flax import serialization
from scipy.io import wavfile

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.data import make_synthetic_dataset
from ddsp_pytorch_tpu.export import load_bundle as jax_load_bundle
from ddsp_pytorch_tpu.export import make_stream_session as jax_make_stream_session
from ddsp_pytorch_tpu.export import make_streaming_synth as jax_make_streaming_synth
from ddsp_pytorch_tpu.utils.audio_io import save_wav as jax_save_wav
from ddsp_pytorch_tpu_torch import export
from ddsp_pytorch_tpu_torch.bundle import msgpack_restore, msgpack_serialize, read_params
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule
from ddsp_pytorch_tpu_torch.data import make_synthetic_dataset as port_make_synthetic_dataset
from ddsp_pytorch_tpu_torch.profile_serving import glide
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.utils import save_wav
from ddsp_pytorch_tpu_torch.weights import state_dict_to_flax

SR, BLOCK, N_BLOCKS, ATOL = 16000, 256, 8, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_trees_equal(got, want):
    assert type(got) is type(want) or isinstance(want, np.ndarray)
    if isinstance(want, dict):
        assert list(got) == sorted(want) or sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_msgpack_serialize_matches_flax():
    rng = np.random.default_rng(0)
    tree = {
        "decoder": {f"Dense_{i}": {"kernel": rng.standard_normal((i + 1, 3)).astype(np.float32),
                                   "bias": np.zeros(3, np.float32)} for i in range(18)},
        "reverb": {"decay": np.array(5.0, np.float32), "wet": np.array(-0.25, np.float32),
                   "noise": rng.uniform(-1, 1, 70_000).astype(np.float32)},
        "gru": {"w_hh": rng.standard_normal((64, 192)).astype(np.float32)},
        "scalars": {"f32": np.float32(1.5), "i64": np.int64(-7), "b": np.bool_(True)},
        "dtypes": {np.dtype(d).name: np.arange(6).astype(d).reshape(2, 3)
                   for d in (np.float64, np.int32, np.uint8, np.bool_, np.int16)},
        "python": [None, True, False, 0, 127, 128, 255, 256, 65_535, 65_536, 2**32, 2**63,
                   -1, -32, -33, -128, -129, -32_768, -32_769, -2**31, -2**31 - 1, -2**63,
                   0.1, "", "x" * 31, "é" * 40, "y" * 300, "z" * 70_000, b"\x00" * 300,
                   list(range(20)), {}],
    }
    got = msgpack_serialize(tree)
    assert got == serialization.msgpack_serialize(tree)
    _assert_trees_equal(serialization.msgpack_restore(got), serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)))
    restored = msgpack_restore(got)
    assert restored["reverb"]["decay"].shape == () and restored["reverb"]["decay"] == 5.0
    np.testing.assert_array_equal(restored["reverb"]["noise"], tree["reverb"]["noise"])
    with pytest.raises(TypeError):
        msgpack_serialize({"t": (1, 2)})


def test_save_wav_matches_jax(tmp_path):
    audio = np.random.default_rng(1).uniform(-1.3, 1.3, 4097).astype(np.float32)
    save_wav(str(tmp_path / "port.wav"), audio, SR)
    jax_save_wav(str(tmp_path / "jax.wav"), audio, SR)
    (sr_a, a), (sr_b, b) = wavfile.read(tmp_path / "port.wav"), wavfile.read(tmp_path / "jax.wav")
    assert sr_a == sr_b == SR and a.dtype == b.dtype == np.int16
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny run the port trained on the CPU: 6 steps, best params saved."""
    root = tmp_path_factory.mktemp("export_run")
    cache = str(root / "cache")
    make_synthetic_dataset(cache, n_items=4, sample_rate=SR, signal_length=8192, block_size=BLOCK,
                           n_harmonic=8)
    cfg = Config.from_dict({
        "preprocess": {"sample_rate": SR, "signal_length": 8192, "block_size": BLOCK, "out_dir": cache},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 32, "n_harmonic": 8, "n_bands": 9, "sample_rate": SR,
            "block_size": BLOCK, "has_reverb": True}},
        "train": {"scales": [512, 256], "batch": 2, "steps": 6, "steps_per_call": 2,
                  "val_interval_epochs": 0, "checkpoint_every_steps": 0},
    })
    dm = Datamodule(cfg)
    dm.setup()
    run_dir = str(root / "tiny")
    trainer = Trainer(cfg, run_dir, device="cpu", use_tensorboard=False)
    state = trainer.fit(dm)
    trainer.close()
    return run_dir, state


def test_exported_bundle_streams_in_jax_like_the_port(run, tmp_path):
    run_dir, _ = run
    out_dir = str(tmp_path / "export")
    bundle = export.export_run(run_dir, out_dir, device="cpu")
    assert bundle == os.path.join(out_dir, "ddsp_tiny_bundle")
    for name in ("ddsp_tiny_bundle/params.msgpack", "ddsp_tiny_bundle/config.yaml",
                 "ddsp_tiny_bundle/meta.json", "ddsp_tiny_config.yaml", "ddsp_tiny_impulse.wav"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    frozen = JaxConfig.from_yaml(os.path.join(run_dir, "config.yaml"))
    assert meta == {
        "format": "ddsp_pytorch_tpu.bundle.v1",
        "model": {"name": frozen.model.name, "kwargs": frozen.model.kwargs},
        "mean_loudness": frozen.data.mean_loudness,
        "std_loudness": frozen.data.std_loudness,
        "sample_rate": SR,
        "block_size": BLOCK,
    }
    assert JaxConfig.from_yaml(os.path.join(bundle, "config.yaml")).to_dict() == frozen.to_dict()

    # the best-loss params, as flax writes them
    best = torch.load(os.path.join(run_dir, "best", "params.pt"), weights_only=True)
    with open(os.path.join(bundle, "params.msgpack"), "rb") as f:
        assert f.read() == serialization.msgpack_serialize(state_dict_to_flax(best))

    _, jparams, _ = jax_load_bundle(bundle)
    _assert_trees_equal(jparams, state_dict_to_flax(best))
    port = export.make_streaming_synth(bundle, device="cpu", noise_deterministic=True)
    ref = jax_make_streaming_synth(bundle, noise_deterministic=True)
    pitch, loud = glide(N_BLOCKS, BLOCK)
    for i in range(N_BLOCKS):
        sl = slice(BLOCK * i, BLOCK * (i + 1))
        got = port.step_samples(pitch[:, sl], loud[:, sl])
        want = ref.step_samples(pitch[:, sl], loud[:, sl])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"block {i}")
    assert float(np.abs(got.numpy()).max()) > 0

    impulse = export._render_impulse(port.model)
    jax_save_wav(str(tmp_path / "jax_impulse.wav"), impulse, SR)
    sr, ir = wavfile.read(os.path.join(out_dir, "ddsp_tiny_impulse.wav"))
    assert sr == SR and ir.shape == (SR,)
    np.testing.assert_array_equal(ir, wavfile.read(tmp_path / "jax_impulse.wav")[1])
    assert abs(ir[0] / 32768.0 - 1.0) < 2e-2  # the dry tap


def test_export_takes_the_newest_checkpoint_without_best(run, tmp_path):
    run_dir, state = run
    copy = str(tmp_path / "nobest")
    shutil.copytree(run_dir, copy)
    shutil.rmtree(os.path.join(copy, "best"))
    bundle = export.export_run(copy, str(tmp_path / "out"), name="last", device="cpu")
    _assert_trees_equal(read_params(bundle), state_dict_to_flax(state.model.state_dict()))
    shutil.rmtree(os.path.join(copy, "checkpoints"))
    os.makedirs(os.path.join(copy, "checkpoints"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export.export_run(copy, str(tmp_path / "out2"), device="cpu")


def test_export_cli(run, tmp_path):
    run_dir, _ = run
    wavs = tmp_path / "wavs"
    (wavs / "train").mkdir(parents=True)
    save_wav(str(wavs / "train" / "a.wav"), np.zeros(64, np.float32), SR)
    save_wav(str(wavs / "b.wav"), np.zeros(64, np.float32), SR)
    out = str(tmp_path / "cli")
    bundle = export.main(["--run", run_dir, "--out-dir", out, "--name", "cli", "--data",
                          "--set", f"data.data_location={wavs}", "--device", "cpu"])
    assert bundle == os.path.join(out, "ddsp_cli_bundle")
    assert Config.from_yaml(os.path.join(bundle, "config.yaml")).data.data_location == str(wavs)
    assert sorted(os.path.relpath(os.path.join(d, f), os.path.join(out, "data"))
                  for d, _, fs in os.walk(os.path.join(out, "data")) for f in fs) == ["b.wav", "train/a.wav"]


def _ae_config(cache, mfcc_ref_db):
    return Config.from_dict({
        "preprocess": {"sample_rate": SR, "signal_length": 8192, "block_size": BLOCK, "out_dir": cache,
                       "mfcc_n_fft": 2 * BLOCK, "mfcc_ref_db": mfcc_ref_db},
        "model": {"name": "mfcc-autoencoder", "kwargs": {
            "hidden_size": 32, "n_harmonic": 8, "n_bands": 17, "sample_rate": SR,
            "block_size": BLOCK, "has_reverb": True}},
        "train": {"scales": [512, 256], "batch": 2, "steps": 6, "steps_per_call": 2,
                  "val_interval_epochs": 0, "checkpoint_every_steps": 0},
    })


@pytest.fixture(scope="module")
def ae_run(tmp_path_factory):
    """A tiny autoencoder run the port trained on the CPU on its own violin
    corpus (MFCCs at the fixed 0 dB reference): 6 steps, best params saved."""
    root = tmp_path_factory.mktemp("export_ae_run")
    cache = str(root / "cache")
    port_make_synthetic_dataset(cache, n_items=4, sample_rate=SR, signal_length=8192, block_size=BLOCK,
                                n_harmonic=8, instrument="violin", mfcc_n_fft=2 * BLOCK, mfcc_ref_db=0.0,
                                device="cpu")
    cfg = _ae_config(cache, 0.0)
    dm = Datamodule(cfg)
    dm.setup()
    run_dir = str(root / "tiny_ae")
    trainer = Trainer(cfg, run_dir, device="cpu", use_tensorboard=False)
    trainer.fit(dm)
    trainer.close()
    return run_dir


def test_exported_autoencoder_streams_in_jax_like_the_port(ae_run, tmp_path):
    """export_run on the AE run: its parameters are the run's bit for bit,
    and the JAX package's make_stream_session streams the bundle (audio in,
    one block of latency) as the port's CPU session does."""
    import warnings

    out_dir = str(tmp_path / "export")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # mfcc_ref_db is set: no warning
        bundle = export.export_run(ae_run, out_dir, device="cpu")
    best = torch.load(os.path.join(ae_run, "best", "params.pt"), weights_only=True)
    exported = export.load_bundle(bundle, device="cpu")[0].state_dict()
    assert exported.keys() == best.keys() and all(torch.equal(exported[k], best[k]) for k in best)
    with open(os.path.join(bundle, "params.msgpack"), "rb") as f:
        assert f.read() == serialization.msgpack_serialize(state_dict_to_flax(best))
    with open(os.path.join(bundle, "meta.json")) as f:
        assert json.load(f)["model"]["name"] == "mfcc-autoencoder"
    assert os.path.exists(os.path.join(out_dir, "ddsp_tiny_ae_impulse.wav"))

    port = export.make_stream_session(bundle, device="cpu", noise_deterministic=True)
    ref = jax_make_stream_session(bundle, noise_deterministic=True)
    assert port.needs_audio and ref.needs_audio
    pitch, loud = glide(N_BLOCKS, BLOCK)
    t = np.arange(N_BLOCKS * BLOCK) / SR
    audio = (0.3 * np.sin(2 * np.pi * np.cumsum(pitch[0]) / SR) + 0.01 * np.sin(2 * np.pi * 3000 * t))
    audio = audio.astype(np.float32)
    peak = 0.0
    for i in range(N_BLOCKS):
        sl = slice(BLOCK * i, BLOCK * (i + 1))
        got = port.step_samples(pitch[0, sl], loud[0, sl], audio[sl])
        want = np.asarray(ref.step_samples(pitch[0, sl], loud[0, sl], audio[sl]))
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"block {i}")
        peak = max(peak, float(np.abs(got).max()))
    assert peak > 0


def test_autoencoder_export_warns_without_a_fixed_mfcc_reference(ae_run, tmp_path):
    """As the JAX package warns (export/__init__.py:66-81): a run whose
    MFCCs used the global-maximum dB reference streams other features."""
    with pytest.warns(UserWarning, match="mfcc_ref_db=None"):
        export.export_run(ae_run, str(tmp_path / "out"), name="warned", device="cpu",
                          overrides=["preprocess.mfcc_ref_db=null"])
