"""The port's native realtime path (ddsp_pytorch_tpu_torch/runtime/) on the
CPU: built with g++ from the package's sources, the engine through ctypes,
its C++ unit test, the Pd external through the mock Pd host, the
CPython-embedded model host in this process and as the standalone
ddsp_host, and the selftest.  The model host runs with DDSP_DEVICE=cpu.

The engine's underrun counter is read and printed, never asserted: whether
the worker kept up depends on the host's load, not on the code (the same
assertion in tests/test_export_runtime.py fails under a loaded host).

Tolerances: the engine's delay is exact (the render callbacks are exact
arithmetic); the model host's stream equals the Python session's
(make_stream_session(device="cpu"), same seed and so the same noise
generator) within 1e-5, as tests/test_export_runtime.py holds the JAX host.
"""

import os
import threading

import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu_torch import runtime
from ddsp_pytorch_tpu_torch.export import make_stream_session
from ddsp_pytorch_tpu_torch.profile_serving import glide
from ddsp_pytorch_tpu_torch.runtime import ModelHost, StreamEngine, selftest


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(ROOT, "pretrained", "ddsp_violin_bundle")
AE_BUNDLE = os.path.join(ROOT, "pretrained", "ddsp_violin_ae_bundle")
HOST_ATOL = 1e-5
BINARY_TIMEOUT_S = 180


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    return runtime.build_runtime()


@pytest.fixture
def cpu_env(monkeypatch):
    """The model host on the CPU; a subprocess's embedded torch at one
    intra-op thread, as the suite's workers run."""
    monkeypatch.setenv("DDSP_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return dict(os.environ)


def test_build_outputs(built):
    for name in ("libddsp_stream.so", "libddsp_model.so", "ddsp_host", "stream_test", "ddsp~.pd_linux",
                 "pd_mock_test"):
        assert os.path.exists(os.path.join(built, name)), name
    assert runtime.build_runtime() == built == runtime.build_dir()


def test_parallel_builds_and_a_failed_build(tmp_path, monkeypatch):
    """Builds racing into one build root all return the one directory
    renamed into place, with every output; a failing compile raises with
    the compiler's output and leaves no directory behind."""
    monkeypatch.setattr(runtime, "BUILD_ROOT", str(tmp_path / "root"))
    results, errors = [], []

    def build():
        try:
            results.append(runtime.build_runtime())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=BINARY_TIMEOUT_S)
    assert not errors and len(results) == 2 and len(set(results)) == 1
    assert sorted(os.listdir(tmp_path / "root")) == [os.path.basename(results[0])]
    assert os.path.exists(os.path.join(results[0], "ddsp~.pd_linux"))

    monkeypatch.setattr(runtime, "BUILD_ROOT", str(tmp_path / "bad"))
    monkeypatch.setattr(runtime, "CXX_FLAGS", runtime.CXX_FLAGS + ["-fno-such-flag-here"])
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*no-such-flag-here"):
        runtime.build_runtime()
    assert os.listdir(tmp_path / "bad") == []


def test_engine_delays_by_two_blocks(built):
    block, tick, n_ticks = 64, 32, 32
    sig = np.arange(n_ticks * tick, dtype=np.float32)
    out = np.zeros_like(sig)
    with StreamEngine(block, lambda p, l: p * 2.0 + l) as eng:
        assert eng.latency == 2 * block
        for t in range(n_ticks):
            sl = slice(t * tick, (t + 1) * tick)
            out[sl] = eng.process(sig[sl], np.ones(tick, np.float32))
        blocks, underruns = eng.blocks_rendered, eng.underruns
    print(f"engine: blocks rendered {blocks}, underruns {underruns}")
    np.testing.assert_array_equal(out[: 2 * block], 0.0)
    np.testing.assert_array_equal(out[2 * block :], 2.0 * sig[: -2 * block] + 1.0)
    assert blocks >= n_ticks * tick // block - 2


def test_engine_audio_channel(built):
    block, tick, n_ticks = 64, 16, 32
    sig = np.arange(n_ticks * tick, dtype=np.float32)
    aud = 1000.0 + sig
    out = np.zeros_like(sig)
    with StreamEngine(block, lambda p, l, a: p + l + a, with_audio=True) as eng:
        for t in range(n_ticks):
            sl = slice(t * tick, (t + 1) * tick)
            out[sl] = eng.process(sig[sl], np.zeros(tick, np.float32), aud[sl])
        # an audio-less tick feeds a silent ring
        for _ in range(3 * block // tick):
            last = eng.process(np.ones(tick, np.float32), np.ones(tick, np.float32))
        print(f"engine (audio): underruns {eng.underruns}")
    np.testing.assert_array_equal(out[2 * block :], sig[: -2 * block] + aud[: -2 * block])
    np.testing.assert_array_equal(last, 2.0)
    with StreamEngine(block, lambda p, l: p) as eng:
        with pytest.raises(ValueError, match="with_audio=False"):
            eng.process(np.zeros(tick, np.float32), np.zeros(tick, np.float32), np.zeros(tick, np.float32))


def test_engine_rejects_bad_tick(built):
    with StreamEngine(64, lambda p, l: p) as eng:
        with pytest.raises(ValueError, match="must divide"):
            eng.process(np.zeros(48, np.float32), np.zeros(48, np.float32))


def test_stream_test_binary(built):
    rc, out, _ = runtime.run_binary("stream_test", timeout=BINARY_TIMEOUT_S)
    print(out)
    assert rc == 0 and "stream_test: PASS (5 tests)" in out


def test_pd_external_without_model(built, cpu_env):
    rc, out, _ = runtime.run_binary("pd_mock_test", runtime.runtime_path("ddsp~.pd_linux"),
                                    timeout=BINARY_TIMEOUT_S, env=cpu_env)
    assert rc == 0 and "pd_mock_test ok (no model" in out, out


@pytest.mark.parametrize("bundle", [BUNDLE, AE_BUNDLE], ids=["violin", "violin_ae"])
def test_pd_external_renders_bundle(built, cpu_env, bundle):
    """`load <bundle>` twice, then 512 ticks of 64 samples through the
    dlopen'd external: finite, audible."""
    rc, out, _ = runtime.run_binary("pd_mock_test", runtime.runtime_path("ddsp~.pd_linux"), bundle,
                                    timeout=BINARY_TIMEOUT_S, env=cpu_env)
    assert rc == 0 and "pd_mock_test ok (bundle" in out, out
    assert out.count("ddsp~: loaded") == 2
    assert ("audio inlet 3 active" in out) == (bundle == AE_BUNDLE)


def test_model_host_decoder_equals_python_session(built, cpu_env):
    host = ModelHost(BUNDLE)
    try:
        assert (host.needs_audio, host.block_size, host.sample_rate) == (False, 512, 48000)
        twin = make_stream_session(BUNDLE, device="cpu")  # seed 0: the host's noise
        pitch, loud = glide(6, 512)
        for k in range(6):
            sl = slice(512 * k, 512 * (k + 1))
            got = host.perform(pitch[0, sl], loud[0, sl])
            want = twin.step_samples(pitch[:, sl], loud[:, sl])[0].numpy()
            np.testing.assert_allclose(got, want, atol=HOST_ATOL, err_msg=f"block {k}")
        assert float(np.abs(got).max()) > 1e-3
        # two blocks in one call
        got = host.perform(pitch[0, :1024], loud[0, :1024])
        np.testing.assert_allclose(got, twin.step_samples(pitch[:, :1024], loud[:, :1024])[0].numpy(),
                                   atol=HOST_ATOL)
        with pytest.raises(RuntimeError, match="refused 100"):
            host.perform(pitch[0, :100], loud[0, :100])
        # a decoder ignores the audio channel
        got = host.perform(pitch[0, :512], loud[0, :512], np.ones(512, np.float32))
        np.testing.assert_allclose(got, twin.step_samples(pitch[:, :512], loud[:, :512])[0].numpy(),
                                   atol=HOST_ATOL)
    finally:
        host.close()


def test_model_host_autoencoder_equals_python_session(built, cpu_env):
    host = ModelHost(AE_BUNDLE)
    try:
        assert host.needs_audio and host.block_size == 512
        block, n_blocks = 512, 5
        t = np.arange(n_blocks * block) / 48000
        audio = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        pitch = np.full(n_blocks * block, 220.0, np.float32)
        loud = np.full(n_blocks * block, -7.5, np.float32)
        with pytest.raises(RuntimeError, match="refused"):
            host.perform(pitch[:block], loud[:block])  # audio-less perform is refused
        twin = make_stream_session(AE_BUNDLE, device="cpu")
        for k in range(n_blocks):
            sl = slice(k * block, (k + 1) * block)
            got = host.perform(pitch[sl], loud[sl], audio[sl])
            want = twin.step_samples(pitch[sl], loud[sl], audio[sl])
            if k == 0:
                np.testing.assert_array_equal(got, 0.0)  # one block of latency
            np.testing.assert_allclose(got, want, atol=HOST_ATOL, err_msg=f"block {k}")
        assert float(np.abs(got).max()) > 1e-3
    finally:
        host.close()


def test_model_host_defaults_to_the_card(built, monkeypatch):
    """Without DDSP_DEVICE the host builds its session on "cuda": it loads
    where there is a card and fails to load where there is none."""
    monkeypatch.delenv("DDSP_DEVICE", raising=False)
    if torch.cuda.is_available():
        with ModelHost(BUNDLE) as host:
            assert host.perform(np.full(512, 220.0, np.float32), np.zeros(512, np.float32)).shape == (512,)
    else:
        with pytest.raises(RuntimeError, match="ddsp_model_load failed"):
            ModelHost(BUNDLE)


def test_ddsp_host_binary(built, cpu_env, tmp_path):
    rc, out, secs = runtime.run_binary("ddsp_host", BUNDLE, "0.5", "64", ROOT, timeout=BINARY_TIMEOUT_S,
                                       env=cpu_env, cwd=str(tmp_path))
    print(out)
    assert rc == 0, out
    assert "loaded bundle: sr=48000 block=512" in out and "pipeline latency: 1024 samples" in out
    assert "underruns:" in out and (tmp_path / "ddsp_host_out.wav").stat().st_size == 44 + 2 * 24000


def test_selftest_on_cpu(capsys):
    assert selftest.main("cpu") == 0
    assert "runtime selftest: PASS" in capsys.readouterr().out
