"""The port's partitioned convolution against the JAX one and against the
offline causal FFT convolution, across calls, and the in-stream reverb of
the port's StreamingSynth against the JAX one and against the offline
convolution of its own dry stream.

Tolerances: 2e-4 absolute against the offline convolution (the JAX suite's
bound, tests/test_partitioned_conv.py:35: 2B-point against full-length
FFTs of unit-variance signals); 1e-5 against the JAX function on the same
partitions (the same FFT sizes and products, two FFT libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddsp_pytorch_tpu.ops import partitioned_conv as jpconv
from ddsp_pytorch_tpu.streaming import StreamingSynth as JaxStreamingSynth
from ddsp_pytorch_tpu_torch.ops import fft_convolve
from ddsp_pytorch_tpu_torch.ops import partitioned_conv as pconv
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth
from tests.test_torch_voice_pool import tiny_models

OFFLINE_ATOL = 2e-4
JAX_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _offline(x: np.ndarray, ir: np.ndarray) -> np.ndarray:
    t = x.shape[-1]
    ir_t = torch.tensor(ir)
    ir_t = F.pad(ir_t, (0, t - len(ir))) if len(ir) < t else ir_t[:t]
    return fft_convolve(torch.tensor(x), ir_t[None]).numpy()


@pytest.mark.parametrize("length,block", [(100, 32), (256, 64), (63, 16)])
def test_streaming_matches_offline_and_jax(length, block):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, 512)).astype(np.float32)
    ir = rng.standard_normal(length).astype(np.float32)
    pir = pconv.partition_ir(torch.tensor(ir), block)
    got, state = pconv.streaming_convolve(pir, pconv.init_state(pir, (2,)), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), _offline(x, ir), atol=OFFLINE_ATOL)

    jpir = jpconv.partition_ir(jnp.asarray(ir), block)
    np.testing.assert_allclose(pir.spectra.numpy(), np.asarray(jpir.spectra), atol=JAX_ATOL)
    want, jstate = jpconv.streaming_convolve(jpir, jpconv.init_state(jpir, (2,)), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_ATOL)
    np.testing.assert_allclose(state.x_hist.numpy(), np.asarray(jstate.x_hist), atol=JAX_ATOL)
    np.testing.assert_array_equal(state.prev.numpy(), np.asarray(jstate.prev))


def test_state_carries_across_calls():
    """Irregular chunks (1, 2, 1, 5 and 3 blocks) equal one call, the
    offline convolution and the JAX function fed the same chunks."""
    rng = np.random.default_rng(1)
    block, chunks = 32, (1, 2, 1, 5, 3)
    x = rng.standard_normal((3, block * sum(chunks))).astype(np.float32)
    ir = rng.standard_normal(150).astype(np.float32)
    pir = pconv.partition_ir(torch.tensor(ir), block)
    jpir = jpconv.partition_ir(jnp.asarray(ir), block)
    state, jstate = pconv.init_state(pir, (3,)), jpconv.init_state(jpir, (3,))
    outs, jouts, pos = [], [], 0
    for k in chunks:
        sl = slice(pos, pos + k * block)
        y, state = pconv.streaming_convolve(pir, state, torch.tensor(x[:, sl]))
        jy, jstate = jpconv.streaming_convolve(jpir, jstate, jnp.asarray(x[:, sl]))
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
        pos += k * block
    got = np.concatenate(outs, axis=-1)
    one, _ = pconv.streaming_convolve(pir, pconv.init_state(pir, (3,)), torch.tensor(x))
    np.testing.assert_allclose(got, one.numpy(), atol=JAX_ATOL)
    np.testing.assert_allclose(got, _offline(x, ir), atol=OFFLINE_ATOL)
    np.testing.assert_allclose(got, np.concatenate(jouts, axis=-1), atol=JAX_ATOL)


def test_streaming_convolve_is_pure():
    rng = np.random.default_rng(2)
    pir = pconv.partition_ir(torch.tensor(rng.standard_normal(64).astype(np.float32)), 16)
    state = pconv.init_state(pir, (1,))
    _, state = pconv.streaming_convolve(pir, state, torch.tensor(rng.standard_normal((1, 32)),
                                                                 dtype=torch.float32))
    kept = [t.clone() for t in state]
    x = torch.tensor(rng.standard_normal((1, 48)), dtype=torch.float32)
    a, _ = pconv.streaming_convolve(pir, state, x)
    b, _ = pconv.streaming_convolve(pir, state, x)
    assert torch.equal(a, b) and all(torch.equal(k, t) for k, t in zip(kept, state))


def test_bad_chunk_size_rejected():
    pir = pconv.partition_ir(torch.ones(64), 32)
    with pytest.raises(ValueError, match="multiple"):
        pconv.streaming_convolve(pir, pconv.init_state(pir), torch.ones(40))


def test_streaming_synth_reverb_matches_jax_and_offline():
    """StreamingSynth(include_reverb=True) on a tiny model with a trained-
    looking reverb: each block equals the JAX synth's (deterministic noise,
    1e-4: the whole decoder in two frameworks, as tests/test_torch_
    streaming.py), and the streamed output equals the offline convolution
    of the dry stream with the model's impulse."""
    jmodel, jparams, tmodel = tiny_models(has_reverb=True)
    wet = StreamingSynth(tmodel, batch=2, noise_deterministic=True, include_reverb=True, device="cpu")
    dry = StreamingSynth(tmodel, batch=2, noise_deterministic=True, device="cpu")
    ref = JaxStreamingSynth(jmodel, jparams, batch=2, noise_deterministic=True, include_reverb=True)
    rng = np.random.default_rng(3)
    wets, drys = [], []
    for i in range(6):
        f = 1 + i % 3  # 1, 2 or 3 frames a call
        f0 = rng.uniform(100, 300, (2, f, 1)).astype(np.float32)
        ld = rng.standard_normal((2, f, 1)).astype(np.float32)
        got = wet.step(f0, ld)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.step(f0, ld)), atol=1e-4,
                                   err_msg=f"call {i}")
        wets.append(got.numpy())
        drys.append(dry.step(f0, ld).numpy())
    with torch.no_grad():
        ir = tmodel.reverb.build_impulse().numpy()
    want = _offline(np.concatenate(drys, axis=-1), ir)
    np.testing.assert_allclose(np.concatenate(wets, axis=-1), want, atol=OFFLINE_ATOL)
    assert float(np.abs(want - np.concatenate(drys, axis=-1)).max()) > 1e-3  # the reverb is heard
