"""The port's public sample-rate ops, the stream-state constructor, the unit
conversions and the package exports, against the JAX package on the CPU.

Tolerances are the JAX suite's: upsample rtol 1e-6 (tests/test_ops_core.py:77),
resample rtol 1e-4 / atol 1e-5 (:97), harmonic_synth within 2e-4 of the
float64 oracle (tests/test_oscillator.py:47-53), amplitude_to_db 1e-5.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddsp_pytorch_tpu.ops as jops
import ddsp_pytorch_tpu.streaming as jstreaming
import ddsp_pytorch_tpu.utils as jutils
from ddsp_pytorch_tpu_torch import ops
from ddsp_pytorch_tpu_torch import streaming, utils
from ddsp_pytorch_tpu_torch.models import DDSPAutoencoder, DDSPDecoder, init_params
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth, init_stream_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# names of the JAX packages' __init__ with no counterpart by design
# (ROADMAP.md §1): the port's TrainState takes create_train_state's place
BY_DESIGN = {"ops": set(), "streaming": set(), "models": set(), "data": set(), "utils": set(),
             "training": {"create_train_state"}}
ORACLE_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle_f64(f0_frames, amp_frames, block, sr):
    """Literal reference math (cumsum over samples) in float64
    (tests/test_oscillator.py:22-28)."""
    f0 = np.repeat(np.asarray(f0_frames, np.float64), block, axis=1)
    amp = np.repeat(np.asarray(amp_frames, np.float64), block, axis=1)
    omega = np.cumsum(2 * np.pi * f0 / sr, axis=1)
    k = np.arange(1, amp.shape[-1] + 1)
    return (np.sin(omega[..., None] * k) * amp).sum(-1)


@pytest.mark.parametrize("factor", [1, 4, 64])
def test_upsample_matches_jax(factor):
    x = np.random.default_rng(factor).standard_normal((3, 7, 5)).astype(np.float32)
    got = ops.upsample(torch.tensor(x), factor)
    assert tuple(got.shape) == (3, 7 * factor, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.upsample(jnp.asarray(x), factor)), rtol=1e-6)


@pytest.mark.parametrize("shape, factor", [((2, 9, 3), 8), ((1, 16, 1), 64), ((3, 5, 2), 1)])
def test_resample_matches_jax(shape, factor):
    x = np.random.default_rng(factor).standard_normal(shape).astype(np.float32)
    got = ops.resample(torch.tensor(x), factor)
    want = np.asarray(jops.resample(jnp.asarray(x), factor))
    assert tuple(got.shape) == want.shape == (shape[0], shape[1] * factor, shape[2])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_harmonic_synth_matches_jax_and_the_f64_oracle():
    """tests/test_oscillator.py:31-53's controls (B 2, F 25, K 8, block 64,
    16 kHz) at sample rate through upsample."""
    rng = np.random.default_rng(0)
    b, f, k, block, sr = 2, 25, 8, 64, 16000
    f0 = rng.uniform(100, 400, (b, f)).astype(np.float32)
    amp = (rng.random((b, f, k)) / k).astype(np.float32)
    f0_up = ops.upsample(torch.tensor(f0)[..., None], block)
    amp_up = ops.upsample(torch.tensor(amp), block)
    got = ops.harmonic_synth(f0_up, amp_up, sr)
    assert tuple(got.shape) == (b, f * block, 1) and got.dtype == torch.float32
    want = np.asarray(jops.harmonic_synth(jnp.asarray(f0_up.numpy()), jnp.asarray(amp_up.numpy()), sr))
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL)
    np.testing.assert_allclose(got[..., 0].numpy(), _oracle_f64(f0, amp, block, sr), atol=ORACLE_ATOL)


def test_harmonic_synth_is_differentiable():
    f0 = torch.full((1, 32, 1), 220.0, requires_grad=True)
    amp = torch.full((1, 32, 4), 0.25, requires_grad=True)
    ops.harmonic_synth(f0, amp, 16000).square().sum().backward()
    assert torch.isfinite(f0.grad).all() and torch.isfinite(amp.grad).all()


@pytest.mark.parametrize("top_db", [80.0, 40.0, None])
def test_amplitude_to_db_matches_jax(top_db):
    rng = np.random.default_rng(3)
    s = np.abs(rng.standard_normal((2, 33, 17))).astype(np.float32) * 1e-2
    s[0, :3] = 0.0  # below amin: the floor
    got = ops.amplitude_to_db(torch.tensor(s), top_db=top_db)
    want = np.asarray(jops.amplitude_to_db(jnp.asarray(s), top_db=top_db))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plots_db_image_is_the_tensor_function():
    """utils/plots.py's numpy dB image (float64, floor 1e-10, 80 dB below
    the maximum) is ops.amplitude_to_db, and equals the JAX package's."""
    from ddsp_pytorch_tpu.utils.plots import _amplitude_to_db as jax_plot_db
    from ddsp_pytorch_tpu_torch.utils.plots import amplitude_to_db as plot_db

    mag = np.abs(np.random.default_rng(4).standard_normal((40, 12))) * 1e-3
    mag[:2] = 0.0
    np.testing.assert_array_equal(plot_db(mag), jax_plot_db(mag))


@pytest.mark.parametrize("batch, seed, enc", [(1, 0, None), (3, 7, None), (2, 5, 24)])
def test_init_stream_state_matches_jax(batch, seed, enc):
    want = jstreaming.init_stream_state(16, batch, seed, enc_hidden_size=enc)
    got = init_stream_state(16, batch, seed, enc_hidden_size=enc, device="cpu")
    for name in ("gru", "phase"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and not g.any()
        np.testing.assert_array_equal(g.numpy(), w)
    assert got.reverb is None and want.reverb is None
    if enc is None:
        assert got.enc_gru is None and want.enc_gru is None
    else:
        assert tuple(got.enc_gru.shape) == np.asarray(want.enc_gru).shape == (batch, enc)
        assert not got.enc_gru.any()
    # the noise generator's state is the seeded generator's
    gen = torch.Generator().manual_seed(seed)
    assert torch.equal(got.noise_state, gen.get_state())


def test_init_stream_state_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_stream_state(16)


@pytest.mark.parametrize("family", ["decoder", "autoencoder"])
def test_fresh_state_is_init_stream_state(family):
    """StreamingSynth.fresh_state builds its state through init_stream_state:
    a step from either state renders the same audio, bit for bit."""
    kw = dict(hidden_size=16, n_harmonic=4, n_bands=5, sample_rate=16000, block_size=64, has_reverb=False)
    model = (DDSPDecoder if family == "decoder" else DDSPAutoencoder)(**kw)
    init_params(model, torch.Generator().manual_seed(0))
    synth = StreamingSynth(model, batch=2, seed=3, device="cpu")
    rng = np.random.default_rng(0)
    f0 = rng.uniform(150, 300, (2, 4, 1)).astype(np.float32)
    lo = rng.standard_normal((2, 4, 1)).astype(np.float32)
    mf = rng.standard_normal((2, 4, 30)).astype(np.float32) if family == "autoencoder" else None
    state = init_stream_state(16, 2, 3, enc_hidden_size=16 if family == "autoencoder" else None, device="cpu")
    a, _ = synth.step_stateless(state, f0, lo, mfcc_frames=mf)
    b, _ = synth.step_stateless(synth.fresh_state(3), f0, lo, mfcc_frames=mf)
    assert torch.equal(a, b) and a.abs().max() > 0


def test_units_match_jax():
    f = np.array([27.5, 110.0, 220.0, 440.0, 1234.5])
    np.testing.assert_array_equal(utils.hz_to_midi(f), jutils.hz_to_midi(f))
    m = np.array([21.0, 60.0, 69.0, 100.5])
    np.testing.assert_array_equal(utils.midi_to_hz(m), jutils.midi_to_hz(m))
    assert utils.midi_to_hz(69) == jutils.midi_to_hz(69) == 440.0
    t = torch.arange(6, dtype=torch.float32, requires_grad=True) * 2
    np.testing.assert_array_equal(utils.tonp(t), jutils.tonp(jnp.arange(6, dtype=jnp.float32) * 2))
    assert isinstance(utils.tonp(t), np.ndarray) and isinstance(utils.tonp([1, 2]), np.ndarray)


def _public_names(path: str) -> set:
    """The names a package's __init__.py imports or defines, without the
    private ones and the modules it imports whole."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("ddsp_pytorch_tpu"):
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("package", sorted(BY_DESIGN))
def test_every_jax_export_is_importable_from_the_port(package):
    import importlib

    names = _public_names(os.path.join(REPO, "ddsp_pytorch_tpu", package, "__init__.py"))
    assert names, package
    port = importlib.import_module(f"ddsp_pytorch_tpu_torch.{package}")
    missing = sorted(n for n in names - BY_DESIGN[package] if not hasattr(port, n))
    assert not missing, f"ddsp_pytorch_tpu_torch.{package} lacks {missing}"


def test_stream_state_jax_and_port_field_names():
    """The port's StreamState carries the JAX one's fields, with the noise
    generator's state in place of the PRNG key."""
    import dataclasses

    jax_fields = {f.name for f in dataclasses.fields(jstreaming.StreamState)}
    port_fields = {f.name for f in dataclasses.fields(streaming.StreamState)}
    assert port_fields == jax_fields - {"rng"} | {"noise_state"}
