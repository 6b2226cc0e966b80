"""The port's StreamingSynth against the JAX one, at full width on the
committed violin bundle (hidden 512, 64 harmonics, 65 noise bands, 48 kHz,
block 512), and the port's streamed output against its offline forward.

Tolerance 1e-4 absolute: the same f32 arithmetic, with 512-wide matmuls,
FFTs and transcendentals from other libraries, carried over 8 GRU steps.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.export import load_bundle as jax_load_bundle
from ddsp_pytorch_tpu.export import make_streaming_synth as jax_make_streaming_synth
from ddsp_pytorch_tpu.streaming import init_stream_state
from ddsp_pytorch_tpu_torch.export import load_bundle, make_streaming_synth
from ddsp_pytorch_tpu_torch.profile_serving import glide
from ddsp_pytorch_tpu_torch.streaming import StreamState

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "pretrained", "ddsp_violin_bundle")
N_BLOCKS = 8
ATOL = 1e-4


@pytest.fixture(scope="module")
def violin():
    jmodel, jparams, jconfig = jax_load_bundle(BUNDLE)
    tmodel, meta = load_bundle(BUNDLE, device="cpu")
    return jmodel, jparams, tmodel, meta


def test_streaming_synth_matches_jax(violin):
    port = make_streaming_synth(BUNDLE, device="cpu", noise_deterministic=True)
    ref = jax_make_streaming_synth(BUNDLE, noise_deterministic=True)
    assert (port.sample_rate, port.block_size) == (48000, 512)
    pitch, loud = glide(N_BLOCKS, 512)
    for i in range(N_BLOCKS):
        sl = slice(512 * i, 512 * (i + 1))
        got = port.step_samples(pitch[:, sl], loud[:, sl])
        want = ref.step_samples(pitch[:, sl], loud[:, sl])
        assert got.device.type == "cpu" and got.shape == (1, 512)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"block {i}")
    np.testing.assert_allclose(port.state.gru.numpy(), np.asarray(ref.state.gru), atol=ATOL)
    assert float(np.abs(got.numpy()).max()) > 1e-3  # not silent


def test_streaming_step_with_injected_noise_matches_jax(violin):
    jmodel, jparams, tmodel, meta = violin
    rng = np.random.default_rng(0)
    pitch, loud = glide(N_BLOCKS, 512)
    f0 = pitch[:, ::512, None]
    ld = (loud[:, ::512, None] - meta["mean_loudness"]) / meta["std_loudness"]
    state = init_stream_state(512, 1)
    j_gru, j_phase = state.gru, state.phase
    t_gru, t_phase = torch.zeros(1, 512), torch.zeros(1)
    for i in range(N_BLOCKS):
        noise = rng.uniform(-1, 1, (1, 1, 512)).astype(np.float32)
        j_audio, j_gru, j_phase = jmodel.apply(
            {"params": jparams}, jnp.asarray(f0[:, i : i + 1]), jnp.asarray(ld[:, i : i + 1]),
            j_gru, j_phase, jnp.asarray(noise), method=jmodel.streaming_step,
        )
        with torch.inference_mode():
            t_audio, t_gru, t_phase = tmodel.streaming_step(
                torch.tensor(f0[:, i : i + 1]), torch.tensor(ld[:, i : i + 1]),
                t_gru, t_phase, torch.tensor(noise),
            )
        np.testing.assert_allclose(t_audio.numpy(), np.asarray(j_audio), atol=ATOL, err_msg=f"block {i}")
        np.testing.assert_allclose(t_phase.numpy(), np.asarray(j_phase), atol=ATOL)
    np.testing.assert_allclose(t_gru.numpy(), np.asarray(j_gru), atol=ATOL)


def test_streamed_equals_offline(violin):
    """Block-by-block streaming with carried state equals one offline
    forward (harmonic + noise, before the reverb) on the same noise."""
    _, _, tmodel, _ = violin
    rng = np.random.default_rng(1)
    pitch, loud = glide(N_BLOCKS, 512)
    f0 = torch.tensor(pitch[:, ::512, None])
    ld = torch.tensor(loud[:, ::512, None] + 8.0)
    noise = torch.tensor(rng.uniform(-1, 1, (1, N_BLOCKS, 512)).astype(np.float32))
    with torch.inference_mode():
        offline = tmodel({"pitch": f0, "loudness": ld}, noise=noise)
        gru, phase, outs = torch.zeros(1, 512), torch.zeros(1), []
        for i in range(N_BLOCKS):
            audio, gru, phase = tmodel.streaming_step(
                f0[:, i : i + 1], ld[:, i : i + 1], gru, phase, noise[:, i : i + 1]
            )
            outs.append(audio)
    streamed = torch.cat(outs, dim=-1)
    dry = offline["harmonic_audio"] + offline["noise"]
    np.testing.assert_allclose(streamed.numpy(), dry.numpy(), atol=ATOL)
    assert offline["signal"].shape == dry.shape


def test_generator_noise_is_per_state():
    """Without noise_deterministic: the same seed repeats, another seed
    does not."""
    port = make_streaming_synth(BUNDLE, device="cpu", seed=3)
    pitch, loud = glide(1, 512)
    s1, s2, s3 = port.fresh_state(3), port.fresh_state(3), port.fresh_state(4)
    a1, _ = port.step_stateless(s1, pitch[:, ::512, None], loud[:, ::512, None])
    a2, _ = port.step_stateless(s2, pitch[:, ::512, None], loud[:, ::512, None])
    a3, _ = port.step_stateless(s3, pitch[:, ::512, None], loud[:, ::512, None])
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)
    with pytest.raises(ValueError):
        port.step_samples(pitch[:, :100], loud[:, :100])


def _state_copy(state):
    return StreamState(gru=state.gru.clone(), phase=state.phase.clone(),
                       noise_state=state.noise_state.clone())


def _assert_states_equal(a, b):
    assert torch.equal(a.gru, b.gru) and torch.equal(a.phase, b.phase)
    assert torch.equal(a.noise_state, b.noise_state)


def test_step_stateless_replay_is_identical_and_pure():
    """Stepping one state twice gives bit-identical audio and next states,
    and leaves the state passed in as it was; the next state's noise has
    moved on."""
    port = make_streaming_synth(BUNDLE, device="cpu", seed=5)
    pitch, loud = glide(2, 512)
    f0, ld = pitch[:, ::512, None], loud[:, ::512, None]
    state = port.fresh_state(5)
    before = _state_copy(state)
    a1, n1 = port.step_stateless(state, f0[:, :1], ld[:, :1])
    a2, n2 = port.step_stateless(state, f0[:, :1], ld[:, :1])
    _assert_states_equal(state, before)
    assert torch.equal(a1, a2)
    _assert_states_equal(n1, n2)
    assert not torch.equal(n1.noise_state, state.noise_state)
    b1, _ = port.step_stateless(n1, f0[:, :1], ld[:, :1])
    assert not torch.equal(a1, b1)  # same controls and carries, fresh noise


def test_forked_states_draw_identical_noise():
    """Two holders of copies of one state render the same blocks: the noise
    is not one stream shared between them."""
    port = make_streaming_synth(BUNDLE, device="cpu", seed=6)
    pitch, loud = glide(3, 512)
    f0, ld = pitch[:, ::512, None], loud[:, ::512, None]
    _, state = port.step_stateless(port.fresh_state(6), f0[:, :1], ld[:, :1])
    left, right = state, _state_copy(state)
    for i in range(1, 3):
        a, left = port.step_stateless(left, f0[:, i : i + 1], ld[:, i : i + 1])
        b, right = port.step_stateless(right, f0[:, i : i + 1], ld[:, i : i + 1])
        assert torch.equal(a, b), f"block {i}"
        _assert_states_equal(left, right)


def test_step_streams_repeat_by_seed():
    """`step` carries the state: one seed repeats its whole stream, equal to
    chained step_stateless calls; another seed gives another stream."""
    pitch, loud = glide(4, 512)
    streams = []
    for seed in (7, 7, 8):
        port = make_streaming_synth(BUNDLE, device="cpu", seed=seed)
        streams.append(torch.cat([port.step_samples(pitch[:, 512 * i : 512 * (i + 1)],
                                                    loud[:, 512 * i : 512 * (i + 1)])
                                  for i in range(4)], dim=-1))
    assert torch.equal(streams[0], streams[1]) and not torch.equal(streams[0], streams[2])
    port = make_streaming_synth(BUNDLE, device="cpu", seed=7)
    state, outs = port.fresh_state(7), []
    for i in range(4):
        audio, state = port.step_stateless(state, pitch[:, 512 * i : 512 * i + 1, None],
                                           loud[:, 512 * i : 512 * i + 1, None])
        outs.append(audio)
    assert torch.equal(torch.cat(outs, dim=-1), streams[0])
