"""The port's CREPE tracker and its fusion with YIN (models/crepe.py) against
the JAX package's (ddsp_pytorch_tpu/models/crepe.py), on the CPU, on the same
inputs made from a seed with numpy.

Tolerances:
  * the cents codec: 1e-6 relative; the resampler: 1e-6 of the peak;
  * the network: the shipped `tiny` weights, logits within 1e-4 absolute
    and salience within 1e-5; a fresh flax `micro`, logits within 1e-5;
    one layer (conv, BatchNorm, the frame normalization) within 1e-5;
  * the decoders: cents within 1e-4 cents plus two float32 ulps of the
    value (2.4e-7 relative: the grid spans 2051-9231 cents, where one ulp
    is 2.4e-4 to 9.8e-4 cents, so a sum taken in another order can move a
    result by more than 1e-4 alone), Viterbi paths equal on every frame,
    f0 within 1e-5 relative;
  * the trackers on a glide with pink noise: Viterbi paths equal, f0
    within 1e-4 relative, both evidence maps within 1e-5.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import serialization

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.data.preprocess import make_pitch_fn as jax_make_pitch_fn
from ddsp_pytorch_tpu.models import crepe as J
from ddsp_pytorch_tpu.ops.pitch import _viterbi as jax_viterbi
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import preprocess as port_preprocess
from ddsp_pytorch_tpu_torch.data.preprocess import default_crepe_params, make_pitch_fn
from ddsp_pytorch_tpu_torch.models import crepe as P
from ddsp_pytorch_tpu_torch.ops.pitch import switch_cost
from ddsp_pytorch_tpu_torch.weights import crepe_flax_from_state_dict, crepe_state_dict_from_flax

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "pretrained", "crepe_tiny.msgpack")
LOGITS_ATOL, SALIENCE_ATOL, FRESH_ATOL, LAYER_ATOL = 1e-4, 1e-5, 1e-5, 1e-5
CENTS_ATOL, CENTS_RTOL, F0_DECODE_RTOL, F0_TRACK_RTOL, EVIDENCE_ATOL = 1e-4, 2.4e-7, 1e-5, 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _shipped_tree():
    with open(SHIPPED, "rb") as f:
        return serialization.msgpack_restore(bytearray(f.read()))


@functools.lru_cache(maxsize=None)
def _shipped_model():
    return P.load_crepe(SHIPPED, device="cpu")


@functools.lru_cache(maxsize=None)
def _fresh_flax(capacity="micro", seed=0):
    """A fresh flax init's params, with running statistics drawn from the
    seed (an init's are 0 and 1, under which BatchNorm is near identity)."""
    variables = J.CREPE(capacity=capacity).init({"params": jax.random.PRNGKey(seed)},
                                                jnp.zeros((2, J.FRAME_LENGTH)))
    rng = np.random.default_rng(seed)
    stats = {layer: {"mean": rng.normal(0.0, 0.1, v["mean"].shape).astype(np.float32),
                     "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for layer, v in variables["batch_stats"].items()}
    return {"params": jax.device_get(variables["params"]), "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def _jax_apply(capacity):
    return jax.jit(J.CREPE(capacity).apply)


def _jax_logits(tree, capacity, frames):
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    return np.asarray(_jax_apply(capacity)(variables, jnp.asarray(frames)))


def _port_logits(model, frames):
    with torch.no_grad():
        return model(torch.tensor(frames)).numpy()


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _glide(sr, seconds, seed, f_lo=196.0, f_hi=392.0, noise_db=-20.0):
    """A 5-harmonic glide from f_lo to f_hi plus pink noise at `noise_db`
    of the tone's peak; returns (audio float32, f0 per sample)."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    f0 = f_lo * (f_hi / f_lo) ** (np.arange(n) / n)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    tone = sum(0.4 / h * np.sin(h * phase) for h in range(1, 6))
    spec = np.fft.rfft(rng.standard_normal(n))
    pink = np.fft.irfft(spec / np.sqrt(np.arange(spec.size) + 1.0), n)
    pink *= 10 ** (noise_db / 20) * np.abs(tone).max() / np.abs(pink).max()
    return (tone + pink).astype(np.float32), f0


# ---------------------------------------------------------------- codec


def test_cents_codec_matches_jax():
    np.testing.assert_array_equal(P.cents_grid(), J.cents_grid())
    rng = np.random.default_rng(0)
    cents = rng.uniform(1000, 7500, 64).astype(np.float32)
    hz = rng.uniform(20, 4000, 64).astype(np.float32)
    np.testing.assert_allclose(P.cents_to_hz(torch.tensor(cents)).numpy(),
                               np.asarray(J.cents_to_hz(jnp.asarray(cents))), rtol=1e-6)
    np.testing.assert_allclose(P.hz_to_cents(torch.tensor(hz)).numpy(),
                               np.asarray(J.hz_to_cents(jnp.asarray(hz))), rtol=1e-6)
    np.testing.assert_allclose(P.hz_to_cents(hz), np.asarray(J.hz_to_cents(jnp.asarray(hz))), rtol=1e-6)
    assert float(P.hz_to_cents(torch.tensor([0.0]))[0]) == pytest.approx(float(J.hz_to_cents(0.0)), rel=1e-6)


@pytest.mark.parametrize("sr", [16000, 22050, 44100, 48000])
def test_resampler_matches_jax(sr):
    x = np.random.default_rng(sr).standard_normal(sr // 4 + 13).astype(np.float32)
    want = np.asarray(J.resample_to_model_rate(jnp.asarray(x), sr))
    got = P.resample_to_model_rate(torch.tensor(x), sr).numpy()
    assert got.shape == want.shape == (-(-x.size * 16000 // sr),)
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())
    # a batch resamples row by row
    rows = P.resample_to_model_rate(torch.tensor(np.stack([x, -x])), sr).numpy()
    np.testing.assert_array_equal(rows[0], got)


@pytest.mark.parametrize("sr, block", [(16000, 256), (48000, 512), (44100, 512)])
def test_salience_frames_and_hop_match_jax(sr, block):
    x, _ = _glide(sr, 0.5, seed=1)
    want, hop_want = J.crepe_salience(jnp.asarray(x), sr, block, _shipped_tree())
    got, hop = P.crepe_salience(x, sr, block, _shipped_model(), device="cpu")
    assert hop == hop_want == P.crepe_hop(sr, block)
    assert got.shape == want.shape == (1 + -(-x.size * 16000 // sr) // hop, P.N_BINS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SALIENCE_ATOL)


# -------------------------------------------------------------- network


def test_shipped_tiny_weights_match_jax():
    frames = np.random.default_rng(2).standard_normal((64, P.FRAME_LENGTH)).astype(np.float32)
    frames[:8] *= 1e-3  # quiet frames, normalized like loud ones
    want = _jax_logits(_shipped_tree(), "tiny", frames)
    got = _port_logits(_shipped_model(), frames)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL)
    np.testing.assert_allclose(_sigmoid(got), _sigmoid(want), atol=SALIENCE_ATOL)


def test_fresh_micro_matches_jax():
    tree = _fresh_flax("micro")
    frames = np.random.default_rng(3).standard_normal((16, P.FRAME_LENGTH)).astype(np.float32)
    model = P.crepe_from_tree(tree, device="cpu")
    assert model.capacity == "micro"
    np.testing.assert_allclose(_port_logits(model, frames), _jax_logits(tree, "micro", frames), atol=FRESH_ATOL)


@pytest.mark.parametrize("capacity", ["micro", "tiny"])
def test_architecture_shapes(capacity):
    """360 logits; the classifier reads 4 time steps × 16·mult channels;
    every state_dict entry has the shape of its flax leaf, laid out."""
    mult = P.CAPACITIES[capacity]
    model = P.CREPE(capacity).eval()
    assert model.classifier.in_features == 4 * 16 * mult
    assert _port_logits(model, np.zeros((3, P.FRAME_LENGTH), np.float32)).shape == (3, P.N_BINS)
    tree = jax.eval_shape(J.CREPE(capacity).init, jax.random.PRNGKey(0), jnp.zeros((2, J.FRAME_LENGTH)))
    sd = crepe_state_dict_from_flax(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), tree))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert tuple(sd["conv1.weight"].shape) == (32 * mult, 1, 512)
    assert tuple(sd["classifier.weight"].shape) == (P.N_BINS, 4 * 16 * mult)


@pytest.mark.parametrize("source", ["shipped-tiny", "fresh-micro"])
def test_state_dict_round_trip_is_bitwise(source):
    tree = _shipped_tree() if source == "shipped-tiny" else _fresh_flax("micro")
    back = crepe_flax_from_state_dict(P.crepe_from_tree(tree, device="cpu").state_dict())
    assert sorted(back) == ["batch_stats", "params"]
    for collection in back:
        assert sorted(back[collection]) == sorted(tree[collection])
        for layer, leaves in tree[collection].items():
            assert sorted(back[collection][layer]) == sorted(leaves)
            for name, value in leaves.items():
                got = back[collection][layer][name]
                assert got.dtype == np.float32 and got.shape == np.shape(value), (layer, name)
                np.testing.assert_array_equal(got, np.asarray(value))
    with pytest.raises(ValueError, match="capacity"):
        P.crepe_from_tree(tree, "small", device="cpu")


@pytest.mark.parametrize("layer, length, kernel, stride, pads",
                         [("conv1", 1024, 512, 4, (254, 254)), ("conv2", 128, 64, 1, (31, 32))])
def test_conv_same_padding_and_layout_match_flax(layer, length, kernel, stride, pads):
    """flax "SAME" with an even kernel pads the odd sample on the right;
    its (k, in, out) kernel becomes torch's (out, in, k), unflipped."""
    assert P._same_padding(length, kernel, stride) == pads
    rng = np.random.default_rng(5)
    c_in, c_out = (1, 8) if layer == "conv1" else (8, 4)
    x = rng.standard_normal((2, length, c_in)).astype(np.float32)
    conv = fnn.Conv(c_out, kernel_size=(kernel,), strides=(stride,), padding="SAME")
    params = conv.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    params = {"kernel": rng.standard_normal(params["kernel"].shape).astype(np.float32) / kernel,
              "bias": rng.standard_normal(params["bias"].shape).astype(np.float32)}
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))  # (B, T', C)
    sd = crepe_state_dict_from_flax({"params": {"c": params}, "batch_stats": {}})
    got = torch.nn.functional.conv1d(torch.nn.functional.pad(torch.tensor(x).transpose(1, 2), pads),
                                     sd["c.weight"], sd["c.bias"], stride=stride)
    assert got.shape[-1] == -(-length // stride)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=LAYER_ATOL)


def test_batchnorm_eval_matches_flax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 10, 16)).astype(np.float32)
    stats = {"mean": rng.standard_normal(16).astype(np.float32),
             "var": rng.uniform(1e-4, 3, 16).astype(np.float32)}
    params = {"scale": rng.standard_normal(16).astype(np.float32), "bias": rng.standard_normal(16).astype(np.float32)}
    want = np.asarray(fnn.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    bn = P.BatchNormEval(16)
    sd = crepe_state_dict_from_flax({"params": {"bn": params}, "batch_stats": {"bn": stats}})
    bn.load_state_dict({k[len("bn."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = bn(torch.tensor(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL)


def test_frame_normalization_is_population_std_with_floor():
    """Frames are normalized by jnp.std (the population std), floored at
    1e-6: a sample std would scale every input by sqrt(1024/1023), and a
    constant frame would divide by zero."""
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((4, P.FRAME_LENGTH)).astype(np.float32) + 3.0
    frames[1] = 0.25  # constant
    frames[2] *= 1e-8  # below the floor
    tree = _fresh_flax("micro")
    model = P.crepe_from_tree(tree, device="cpu")
    got = _port_logits(model, frames)
    np.testing.assert_allclose(got, _jax_logits(tree, "micro", frames), atol=FRESH_ATOL)
    assert np.isfinite(got).all()


# ------------------------------------------------------------- decoders


def _bumps(bins, rng):
    """(len(bins), 360) salience: a Gaussian bump (σ 1.3 bins) at each bin,
    off-center by up to a third of a bin, on a low noise floor."""
    grid = np.arange(P.N_BINS)
    centers = np.asarray(bins, float) + rng.uniform(-0.33, 0.33, len(bins))
    sal = np.exp(-0.5 * ((grid[None] - centers[:, None]) / 1.3) ** 2)
    return (0.9 * sal + 0.01 * rng.random(sal.shape)).astype(np.float32)


def test_salience_to_cents_matches_jax_at_the_edges():
    rng = np.random.default_rng(8)
    sal = _bumps([0, 1, 2, 3, 100, 356, 357, 358, 359], rng)
    sal = np.concatenate([sal, np.zeros((1, P.N_BINS), np.float32)])  # all zero: the 1e-9 floor
    tie = np.zeros((1, P.N_BINS), np.float32)
    tie[0, [40, 200]] = 0.8  # a tie: the first index wins, as jnp.argmax
    sal = np.concatenate([sal, tie])
    want = np.asarray(J.salience_to_cents(jnp.asarray(sal)))
    got = P.salience_to_cents(torch.tensor(sal)).numpy()
    np.testing.assert_allclose(got, want, atol=CENTS_ATOL, rtol=CENTS_RTOL)
    assert abs(got[-1] - P.cents_grid()[40]) < 1e-3


def _switch(per_octave):
    return jnp.asarray(switch_cost(P.N_BINS, P.BINS_PER_OCTAVE, per_octave))


def test_viterbi_cents_matches_jax_on_an_octave_jump():
    """tests/test_crepe.py's case: one frame whose octave-up peak is the
    stronger, inside a steady track; and a batch of two such maps."""
    grid = J.cents_grid()
    base = np.exp(-0.5 * ((grid - grid[120]) / 25.0) ** 2)
    jump = 0.7 * base + np.exp(-0.5 * ((grid - grid[120] - 1200.0) / 25.0) ** 2)
    track = np.tile(base, (9, 1)).astype(np.float32)
    track[4] = jump
    want = np.asarray(J.viterbi_cents(jnp.asarray(track)))
    got = P.viterbi_cents(torch.tensor(track)).numpy()
    np.testing.assert_allclose(got, want, atol=CENTS_ATOL, rtol=CENTS_RTOL)
    assert abs(got[4] - grid[120]) < 40.0
    emission = -np.log(np.clip(track, 1e-6, 1.0))
    np.testing.assert_array_equal(P.viterbi_path(torch.tensor(emission), 3.0),
                                  np.asarray(jax_viterbi(jnp.asarray(emission), _switch(3.0))))
    batch = np.stack([track, track[::-1]])
    got_b = P.viterbi_cents(torch.tensor(batch)).numpy()
    np.testing.assert_allclose(got_b[1], np.asarray(J.viterbi_cents(jnp.asarray(track[::-1]))), atol=CENTS_ATOL, rtol=CENTS_RTOL)
    np.testing.assert_array_equal(got_b[0], got)


def _fused_cost_np(sal, d, yin_weight, switch_weight, floor, gate, keep):
    cost = -np.log(np.clip(sal, floor, 1.0))
    if gate > 0:
        cost = cost * sal.max(axis=-1, keepdims=True) ** gate
    cost = (cost + yin_weight * d).astype(np.float32)
    return cost if keep is None else np.where(keep, cost, np.float32(1e6))


@pytest.mark.parametrize("keep", [False, True], ids=["all-bins", "keep"])
@pytest.mark.parametrize("gate", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("floor", [1e-6, 0.03])
def test_decode_fused_matches_jax(keep, gate, floor):
    rng = np.random.default_rng(9)
    frames = 40
    track = 150 + 30 * np.sin(np.arange(frames) / 6.0)
    track[18:21] += 60  # a transient jump to an octave up
    sal = _bumps(track, rng)
    sal[25:30] *= 0.05  # unconfident frames: the gate defers to YIN
    d = 1.0 - 0.8 * _bumps(track + 0.4, rng) + 0.05 * rng.random((frames, P.N_BINS)).astype(np.float32)
    d = d.astype(np.float32)
    mask = P.cents_keep(50.0, 1000.0) if keep else None
    kw = dict(yin_weight=8.0, crepe_weight=1.0, switch_per_octave=60.0, salience_floor=floor,
              confidence_gate=gate)
    want = np.asarray(J.decode_fused(jnp.asarray(sal), jnp.asarray(d), keep=None if mask is None
                                     else jnp.asarray(mask), **kw))
    got = P.decode_fused(torch.tensor(sal), torch.tensor(d), keep=mask, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=F0_DECODE_RTOL)
    cost = _fused_cost_np(sal, d, 8.0, 60.0, floor, gate, mask)
    np.testing.assert_array_equal(P.viterbi_path(torch.tensor(cost), 60.0),
                                  np.asarray(jax_viterbi(jnp.asarray(cost), _switch(60.0))))


# ------------------------------------------------------------- trackers

TRACKERS = {
    "crepe": (J.extract_pitch_crepe, P.extract_pitch_crepe, {}),
    "crepe-50-2000": (J.extract_pitch_crepe, P.extract_pitch_crepe, dict(fmin=50.0, fmax=2000.0)),
    "hybrid": (J.extract_pitch_hybrid, P.extract_pitch_hybrid, {}),
    "hybrid-50-2000": (J.extract_pitch_hybrid, P.extract_pitch_hybrid, dict(fmin=50.0, fmax=2000.0)),
}


def _paths(sal, d, kw, hybrid):
    """The Viterbi path each side's own evidence gives."""
    if not hybrid:
        if "fmin" in kw:
            sal = np.where(P.cents_keep(kw["fmin"], kw["fmax"]), sal, 0.0)
        cost = -np.log(np.clip(sal, 1e-6, 1.0)).astype(np.float32)
        return cost, 3.0
    keep = P.cents_keep(kw.get("fmin", 32.0), kw.get("fmax", 2100.0))
    return _fused_cost_np(sal, d, 8.0, 60.0, 0.03, 2.0, keep), 60.0


@pytest.mark.parametrize("sr, block", [(16000, 256), (48000, 512)])
@pytest.mark.parametrize("tracker", list(TRACKERS))
def test_trackers_match_jax(sr, block, tracker):
    jax_fn, port_fn, kw = TRACKERS[tracker]
    x, _ = _glide(sr, 0.75, seed=sr + len(tracker))
    want = np.asarray(jax_fn(jnp.asarray(x), sr, block, _shipped_tree(), **kw))
    got = port_fn(x, sr, block, _shipped_model(), device="cpu", **kw).numpy()
    assert got.shape == want.shape == (x.size // block,)
    np.testing.assert_allclose(got, want, rtol=F0_TRACK_RTOL)
    hybrid = tracker.startswith("hybrid")
    ev = dict(fmin=kw.get("fmin", 32.0), fmax=kw.get("fmax", 2100.0))
    sal_j, d_j, _ = J.hybrid_evidence(jnp.asarray(x), sr, block, _shipped_tree(), **ev)
    sal_p, d_p, _ = P.hybrid_evidence(x, sr, block, _shipped_model(), device="cpu", **ev)
    cost_j, switch = _paths(np.asarray(sal_j), np.asarray(d_j), kw, hybrid)
    cost_p, _ = _paths(sal_p.numpy(), d_p.numpy(), kw, hybrid)
    np.testing.assert_array_equal(P.viterbi_path(torch.tensor(cost_p), switch),
                                  np.asarray(jax_viterbi(jnp.asarray(cost_j), _switch(switch))))


@pytest.mark.parametrize("sr, block", [(16000, 256), (48000, 512)])
def test_hybrid_evidence_matches_jax(sr, block):
    x, _ = _glide(sr, 0.5, seed=11)
    for fmin, fmax in ((32.0, 2100.0), (50.0, 2000.0)):
        sal_j, d_j, hop_j = J.hybrid_evidence(jnp.asarray(x), sr, block, _shipped_tree(), fmin=fmin, fmax=fmax)
        sal_p, d_p, hop_p = P.hybrid_evidence(x, sr, block, _shipped_model(), fmin=fmin, fmax=fmax, device="cpu")
        assert hop_p == hop_j and d_p.shape == tuple(d_j.shape) == tuple(sal_j.shape)
        np.testing.assert_allclose(sal_p.numpy(), np.asarray(sal_j), atol=EVIDENCE_ATOL)
        np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), atol=EVIDENCE_ATOL)


def test_block_grid_interpolation_matches_jnp_interp():
    rng = np.random.default_rng(12)
    for n_src, hop, n_out, block, sr in ((48, 170, 47, 512, 48000), (65, 256, 64, 256, 16000),
                                         (30, 185, 31, 512, 44100)):
        f0 = rng.uniform(50, 900, n_src).astype(np.float32)
        want = np.asarray(J._interp_to_block_grid(jnp.asarray(f0), hop, n_out, block, sr))
        got = P.interp_to_block_grid(torch.tensor(f0), hop, n_out, block, sr).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


# -------------------------------------------------------- make_pitch_fn


def _cfg_raw(tracker, crepe_params=None, sr=16000, block=256):
    return {"preprocess": {"sample_rate": sr, "block_size": block, "signal_length": 8192,
                           "pitch_tracker": tracker, "crepe_params": crepe_params}}


@pytest.mark.parametrize("tracker", ["hybrid", "crepe"])
def test_make_pitch_fn_batch_equals_jax_rows(tracker):
    """Three chunks through the port's one batched call equal the JAX
    package's per-row calls (data/preprocess.py:68-73)."""
    rows = np.stack([_glide(16000, 8192 / 16000, seed=20 + i, f_lo=110.0 * (i + 1), f_hi=165.0 * (i + 1))[0]
                     for i in range(3)])
    got = make_pitch_fn(Config.from_dict(_cfg_raw(tracker)), device="cpu")(torch.tensor(rows), 16000, 256)
    jax_fn = jax_make_pitch_fn(JaxConfig.from_dict(_cfg_raw(tracker)))
    want = np.stack([np.asarray(jax_fn(jnp.asarray(r), 16000, 256)) for r in rows])
    assert got.shape == want.shape == (3, 8192 // 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=F0_TRACK_RTOL)


def test_make_pitch_fn_falls_back_to_the_shipped_file(tmp_path, monkeypatch):
    """A recorded crepe_params that does not exist (a bundle's config may
    name another host's path) loads the shipped weights, as does none."""
    assert default_crepe_params() == os.path.realpath(SHIPPED)
    loaded = []
    real = port_preprocess.load_crepe
    monkeypatch.setattr(port_preprocess, "load_crepe", lambda path, *a, **k: loaded.append(path) or real(path, *a, **k))
    missing = str(tmp_path / "elsewhere" / "crepe_tiny.msgpack")
    for recorded in (missing, None):
        fn = make_pitch_fn(Config.from_dict(_cfg_raw("hybrid", recorded)), device="cpu")
        assert fn(torch.zeros(4096), 16000, 256).shape == (16,)
    assert loaded == [default_crepe_params()] * 2


def test_make_pitch_fn_unknown_tracker_raises():
    with pytest.raises(ValueError, match="unknown pitch_tracker"):
        make_pitch_fn(Config.from_dict(_cfg_raw("pyin")), device="cpu")
