"""The port's VoicePool and masked step against independent streams and
against the JAX pool, at a tiny width (hidden 16, 4 harmonics, 5 noise
bands, block 64, 16 kHz), with and without the in-stream reverb, and for
the mfcc-autoencoder.  Mirrors tests/test_voice_pool.py.

Deterministic noise isolates the per-voice arithmetic (the pool's noise is
its own batch-level stream).  Tolerances: a pooled slot against an
independent batch-1 stream of the port 1e-5 (tests/test_voice_pool.py's
bound: the same arithmetic at batch V and 1); the port's pool against the
JAX pool 1e-4 (two frameworks, as tests/test_torch_streaming.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.models.decoder import DDSPDecoder as JaxDecoder
from ddsp_pytorch_tpu.models.encoder import DDSPAutoencoder as JaxAutoencoder
from ddsp_pytorch_tpu.streaming import StreamingSynth as JaxStreamingSynth
from ddsp_pytorch_tpu.streaming.pool import VoicePool as JaxVoicePool
from ddsp_pytorch_tpu_torch.models import load_model
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth
from ddsp_pytorch_tpu_torch.streaming.pool import VoicePool
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict

SR, BLOCK, F = 16000, 64, 4
KW = dict(hidden_size=16, n_harmonic=4, n_bands=5, sample_rate=SR, block_size=BLOCK)
N_MFCC = 30
POOL_ATOL = 1e-5
JAX_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree) -> dict:
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def tiny_models(has_reverb: bool = False, autoencoder: bool = False):
    """(flax model, its params as numpy, the port's model with those
    weights).  The reverb's decay and wet are moved off their initial
    values, so that the in-stream reverb is heard."""
    jcls = JaxAutoencoder if autoencoder else JaxDecoder
    jmodel = jcls(**KW, has_reverb=has_reverb, use_pallas="never")
    batch = {"pitch": jnp.full((1, 8, 1), 220.0), "loudness": jnp.zeros((1, 8, 1))}
    if autoencoder:
        batch["mfcc"] = jnp.zeros((1, 8, N_MFCC))
    params = _np_tree(jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                  batch)["params"])
    if has_reverb:
        params["reverb"]["decay"] = np.float32(1.3)
        params["reverb"]["wet"] = np.float32(-0.7)
    tmodel = load_model("mfcc-autoencoder" if autoencoder else "single-inst-decoder",
                        dict(KW, has_reverb=has_reverb))
    tmodel.load_state_dict(flax_to_state_dict(params))
    return jmodel, params, tmodel.eval()


def _controls(rng, n_steps, autoencoder=False, frames=F):
    out = []
    for _ in range(n_steps):
        c = (rng.uniform(100, 300, (frames, 1)).astype(np.float32),
             rng.standard_normal((frames, 1)).astype(np.float32))
        if autoencoder:
            c += (rng.standard_normal((frames, N_MFCC)).astype(np.float32),)
        out.append(c)
    return out


def _synth(tmodel, batch, **kw):
    return StreamingSynth(tmodel, batch=batch, noise_deterministic=True, device="cpu", **kw)


@pytest.mark.parametrize("has_reverb", [False, True])
def test_pool_matches_independent_streams_and_jax(has_reverb):
    """Slot a streams alone for 2 dispatches, then b joins for 2: each
    slot's audio equals an independent batch-1 stream of the port and the
    JAX pool's audio for the same requests."""
    jmodel, jparams, tmodel = tiny_models(has_reverb)
    pool = VoicePool(_synth(tmodel, 3, include_reverb=has_reverb))
    jpool = JaxVoicePool(JaxStreamingSynth(jmodel, jparams, batch=3, noise_deterministic=True,
                                           include_reverb=has_reverb))
    refs = [_synth(tmodel, 1, include_reverb=has_reverb) for _ in range(2)]
    rng = np.random.default_rng(0)
    ctrl_a, ctrl_b = _controls(rng, 4), _controls(rng, 2)
    a, b = pool.acquire(), None
    assert a == jpool.acquire()
    for i in range(4):
        reqs = {a: ctrl_a[i]}
        if i == 2:
            b = pool.acquire()
            assert b == jpool.acquire() and b != a
        if b is not None:
            reqs[b] = ctrl_b[i - 2]
        outs, jouts = pool.step(reqs), jpool.step(reqs)
        assert sorted(outs) == sorted(reqs)
        for slot, ref, ctrl in ((a, refs[0], ctrl_a[i]), (b, refs[1], ctrl_b[i - 2] if b else None)):
            if ctrl is None:
                continue
            want = ref.step(ctrl[0][None], ctrl[1][None])[0].numpy()
            assert outs[slot].shape == (F * BLOCK,)
            np.testing.assert_allclose(outs[slot], want, atol=POOL_ATOL, err_msg=f"slot {slot} step {i}")
            np.testing.assert_allclose(outs[slot], np.asarray(jouts[slot]), atol=JAX_ATOL)
    assert float(np.abs(outs[a]).max()) > 1e-3


def test_slot_release_gives_fresh_state():
    _, _, tmodel = tiny_models(has_reverb=True)
    pool = VoicePool(_synth(tmodel, 2, include_reverb=True))
    ctrl = _controls(np.random.default_rng(1), 2)
    a = pool.acquire()
    first = pool.step({a: ctrl[0]})[a]
    pool.step({a: ctrl[1]})
    pool.release(a)
    a2 = pool.acquire()
    np.testing.assert_allclose(pool.step({a2: ctrl[0]})[a2], first, atol=1e-6)


def test_release_zeroes_the_slot_in_place():
    """release() zeroes the slot's GRU, phase, reverb line and encoder
    carries in the pool's own tensors; the other slot keeps its state."""
    _, _, tmodel = tiny_models(has_reverb=True, autoencoder=True)
    pool = VoicePool(_synth(tmodel, 2, include_reverb=True))
    a, b = pool.acquire(), pool.acquire()
    for ctrl_a, ctrl_b in zip(*(_controls(np.random.default_rng(s), 2, autoencoder=True) for s in (2, 3))):
        pool.step({a: ctrl_a, b: ctrl_b})
    state = pool._state
    carries = [state.gru, state.phase, state.enc_gru, *state.reverb]
    before = [t.clone() for t in carries]
    pointers = [t.data_ptr() for t in carries]
    assert all(bool(t[a].abs().max() > 0) for t in carries)
    pool.release(a)
    after = pool._state
    now = [after.gru, after.phase, after.enc_gru, *after.reverb]
    assert [t.data_ptr() for t in now] == pointers
    for t, old in zip(now, before):
        assert bool((t[a] == 0).all())
        assert torch.equal(t[b], old[b])


def test_pool_capacity_and_mixed_frames():
    _, _, tmodel = tiny_models()
    pool = VoicePool(_synth(tmodel, 2))
    s1, s2 = pool.acquire(), pool.acquire()
    assert pool.acquire() is None and pool.active_count == 2
    pool.release(s1)
    pool.release(s1)  # a second release is a no-op
    assert pool.active_count == 1 and pool.acquire() is not None
    with pytest.raises(ValueError, match="frame count"):
        pool.step({s2: (np.zeros((2, 1), np.float32), np.zeros((2, 1), np.float32)),
                   0: (np.zeros((3, 1), np.float32), np.zeros((3, 1), np.float32))})
    with pytest.raises(ValueError, match="slot"):
        pool.step({5: (np.zeros((1, 1), np.float32), np.zeros((1, 1), np.float32))})
    # dispatches of different frame counts, one after another
    for f in (1, 3, 2):
        out = pool.step({s2: _controls(np.random.default_rng(f), 1, frames=f)[0]})
        assert out[s2].shape == (f * BLOCK,)


def test_masked_step_keeps_inactive_rows_bit_for_bit():
    _, _, tmodel = tiny_models(has_reverb=True, autoencoder=True)
    synth = _synth(tmodel, 3, include_reverb=True)
    rng = np.random.default_rng(4)
    state = synth.fresh_state()
    f0 = rng.uniform(100, 300, (3, F, 1)).astype(np.float32)
    ld = rng.standard_normal((3, F, 1)).astype(np.float32)
    mf = rng.standard_normal((3, F, N_MFCC)).astype(np.float32)
    _, state = synth.step_stateless(state, f0, ld, mf)
    _, masked = synth.step_stateless_masked(state, f0, ld, [True, False, True], mf)
    _, full = synth.step_stateless(state, f0, ld, mf)
    for old, new, ref in zip([state.gru, state.phase, state.enc_gru, *state.reverb],
                             [masked.gru, masked.phase, masked.enc_gru, *masked.reverb],
                             [full.gru, full.phase, full.enc_gru, *full.reverb]):
        assert torch.equal(new[1], old[1])
        assert torch.equal(new[[0, 2]], ref[[0, 2]]) and not torch.equal(new[0], old[0])
    with pytest.raises(ValueError, match="active"):
        synth.step_stateless_masked(state, f0, ld, [True, False], mf)


def test_pool_noise_advances_every_dispatch():
    """Without deterministic noise the generator is the pool's: two pools
    from one seed repeat each other, and the noise state moves on at every
    dispatch, whichever slots requested."""
    _, _, tmodel = tiny_models()
    pools = [VoicePool(StreamingSynth(tmodel, batch=2, seed=7, device="cpu")) for _ in range(2)]
    ctrl = _controls(np.random.default_rng(5), 2)
    slots = [p.acquire() for p in pools]
    states = [pools[0]._state.noise_state.clone()]
    outs = []
    for c in ctrl:
        outs.append([p.step({s: c})[s] for p, s in zip(pools, slots)])
        states.append(pools[0]._state.noise_state.clone())
    for pair in outs:
        np.testing.assert_array_equal(pair[0], pair[1])
    assert not torch.equal(states[0], states[1]) and not torch.equal(states[1], states[2])


def test_pool_autoencoder_matches_independent_streams_and_jax():
    jmodel, jparams, tmodel = tiny_models(autoencoder=True)
    pool = VoicePool(_synth(tmodel, 3))
    jpool = JaxVoicePool(JaxStreamingSynth(jmodel, jparams, batch=3, noise_deterministic=True))
    refs = [_synth(tmodel, 1) for _ in range(2)]
    ctrl_a, ctrl_b = (_controls(np.random.default_rng(s), 3, autoencoder=True) for s in (6, 7))
    a, b = pool.acquire(), pool.acquire()
    assert (a, b) == (jpool.acquire(), jpool.acquire())
    for i in range(3):
        reqs = {a: ctrl_a[i], b: ctrl_b[i]}
        outs, jouts = pool.step(reqs), jpool.step(reqs)
        for slot, ref, (f0, ld, mf) in ((a, refs[0], ctrl_a[i]), (b, refs[1], ctrl_b[i])):
            want = ref.step(f0[None], ld[None], mf[None])[0].numpy()
            np.testing.assert_allclose(outs[slot], want, atol=POOL_ATOL)
            np.testing.assert_allclose(outs[slot], np.asarray(jouts[slot]), atol=JAX_ATOL)
    with pytest.raises(ValueError, match="mfcc"):
        pool.step({a: ctrl_a[0][:2]})


@pytest.mark.parametrize("passes, want", [
    ((True, True, True), (4, None, True)),        # none failed: a lower bound
    ((True, False, True), (1, 2, False)),         # a failure at a small V counts
    ((False, True, True), (0, 1, False)),
    ((True, True, False), (2, 4, False)),
], ids=["all-pass", "early-failure", "first-fails", "top-fails"])
def test_voices_per_card_is_the_largest_v_below_the_first_failure(passes, want):
    """profile_serving's ramp reading: the largest V below the first V whose
    p99 missed the budget, that V, and whether no V failed."""
    from ddsp_pytorch_tpu_torch.profile_serving import voices_per_card, voices_per_card_text

    rows = [{"voices": v, "realtime_ok_p99": ok} for v, ok in zip((1, 2, 4), passes)]
    got = voices_per_card(rows)
    assert (got["voices_per_card"], got["first_failed_voices"],
            got["voices_per_card_is_lower_bound"]) == want
    assert voices_per_card_text(got).startswith("≥" if want[2] else str(want[0]))
