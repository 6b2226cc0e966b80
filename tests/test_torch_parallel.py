"""The port's parallel layer against the JAX package's, on the CPU.

The same numpy inputs go through the JAX sharded ops on the suite's
8-device virtual CPU mesh (tests/conftest.py) and through the port's ops
on an in-process mesh of the same shape, and both against the unsharded
ops, at the JAX suite's tolerances (tests/test_parallel.py):
  * the time-sharded synth: atol 2e-4 (:42);
  * the sharded loss: rtol 1e-4 (:112);
  * the pad-and-mask loss: rtol 1e-5, its gradient within 1e-6 of its
    peak (:164-167) against the port's unsharded loss, within 1e-4 against
    JAX's (another FFT library; tests/test_torch_spectral_loss.py:83);
  * the sharded reverb: atol 2e-3 (:184).
The port's sharded ops equal its unsharded ones much more closely than
JAX's do (the phase sums run in float64); the measured errors are far
inside these bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.ops import fft_convolve as jax_fft_convolve
from ddsp_pytorch_tpu.ops import harmonic_synth_frames as jax_synth
from ddsp_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from ddsp_pytorch_tpu.parallel.ops import make_time_sharded_loss as jax_sharded_loss
from ddsp_pytorch_tpu.parallel.ops import make_time_sharded_reverb as jax_sharded_reverb
from ddsp_pytorch_tpu.parallel.ops import make_time_sharded_synth as jax_sharded_synth
from ddsp_pytorch_tpu.training.loss import spectral_loss_from_signals as jax_loss
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import DDSPDecoder, init_params
from ddsp_pytorch_tpu_torch.ops import fft_convolve, harmonic_synth_frames, phase_accumulate_frames
from ddsp_pytorch_tpu_torch.parallel import make_mesh, shard_batch, shard_time_batch
from ddsp_pytorch_tpu_torch.parallel.ops import (
    make_time_sharded_loss,
    make_time_sharded_reverb,
    make_time_sharded_synth,
    reflect_tail_into_pad,
    sharded_multiscale_spec_loss,
    sharded_phase_offsets,
    to_time_shards,
)
from ddsp_pytorch_tpu_torch.training import make_optimizer, make_train_step
from ddsp_pytorch_tpu_torch.training.loss import spectral_loss_from_signals
from ddsp_pytorch_tpu_torch.training.state import TrainState

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) JAX devices")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mesh_shapes():
    mesh = make_mesh(data=4, time=2)
    assert mesh.shape == {"data": 4, "time": 2} and mesh.in_process and mesh.is_primary
    assert make_mesh(data=-1, time=2).shape == {"data": 1, "time": 2}
    axis = make_mesh(2, 4).time_axis
    assert (axis.n, axis.first, axis.count) == (4, 0, 4)
    assert make_mesh(2, 4).data_procs == 1
    with pytest.raises(ValueError):
        make_mesh(0, 2)


@pytest.mark.parametrize("k", [1, 2, -1, -3, 4])
def test_in_process_shift_and_its_transpose(k):
    """shift(x, k): shard g gets shard g − k's slice, zeros off the axis
    (JAX's ppermute); autograd's transpose is shift(·, −k)."""
    axis = make_mesh(1, 4).time_axis
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((4, 2, 3)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((4, 2, 3)))
    y = axis.shift(x, k)
    for g in range(4):
        want = x[g - k] if 0 <= g - k < 4 else torch.zeros_like(x[0])
        assert torch.equal(y[g], want)
    if abs(k) < 4:  # past the axis the result is a constant zero
        (grad,) = torch.autograd.grad((w * y).sum(), x)
        assert torch.equal(grad, axis.shift(w, -k))
    assert torch.equal(axis.all_gather(x), x)


def test_sharded_phase_offsets_equal_the_unsharded_scan(rng):
    """The distributed float64 scan gives the unsharded scan's float32
    phases (ops/oscillator.phase_accumulate_frames) to one rounding."""
    f0 = torch.tensor(rng.uniform(100, 4000, (3, 96)).astype(np.float32))
    want, want_out = phase_accumulate_frames(f0, 512, 48000)
    axis = make_mesh(1, 4).time_axis
    phi, out = sharded_phase_offsets(to_time_shards(f0, axis), 512, 48000, axis)
    got = phi.movedim(0, 1).reshape(3, 96)
    assert float((got - want).abs().max()) <= 4.8e-7  # one float32 ulp at 2π
    assert float((out[-1] - want_out).abs().max()) <= 4.8e-7


def test_time_sharded_harmonic_synth_matches_jax_and_unsharded(rng):
    """(data 2, time 4): the port's sharded bank against JAX's sharded bank
    and against the unsharded bank (atol 2e-4, test_parallel.py:42)."""
    b, f, k, block, sr = 2, 64, 8, 64, 16000
    f0 = rng.uniform(100, 400, (b, f)).astype(np.float32)
    amp = (rng.random((b, f, k)) / k).astype(np.float32)
    jmesh = jax_make_mesh(data=2, time=4)
    want_jax = np.asarray(jax.jit(jax_sharded_synth(jmesh, block, sr, use_pallas="never"))(
        jnp.asarray(f0), jnp.asarray(amp)))
    got = make_time_sharded_synth(make_mesh(2, 4), block, sr)(torch.tensor(f0), torch.tensor(amp))
    want = harmonic_synth_frames(torch.tensor(f0), torch.tensor(amp), block, sr)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)
    np.testing.assert_allclose(jax_synth(jnp.asarray(f0), jnp.asarray(amp), block, sr,
                                         use_pallas="never"), want.numpy(), atol=2e-4)


def test_time_sharded_loss_matches_jax_and_unsharded(rng):
    b, t = 2, 8192
    scales, overlap = [512, 256, 128], 0.75
    x = rng.standard_normal((b, t)).astype(np.float32)
    y = rng.standard_normal((b, t)).astype(np.float32)
    want, _, _ = spectral_loss_from_signals(torch.tensor(x), torch.tensor(y), scales, overlap)
    want_jax = jax.jit(jax_sharded_loss(jax_make_mesh(data=2, time=4), scales, overlap))(
        jnp.asarray(x), jnp.asarray(y))
    got = make_time_sharded_loss(make_mesh(2, 4), scales, overlap)(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    np.testing.assert_allclose(float(got), float(want_jax), rtol=1e-4)


def test_padded_masked_loss_and_grads_match_unsharded(rng):
    """Pad-and-mask in isolation (test_parallel.py:115-167): the sharded
    loss of zero-padded signals, pad regions rewritten with the reflection
    about the true end and frames past it masked, equals the unsharded loss
    of the unpadded signals — the port's and JAX's — in value (rtol 1e-5)
    and gradient: the port's unsharded one within 1e-6 of its peak (measured
    8.3e-8), JAX's, another FFT library, within 1e-4 (measured 6.9e-5, as
    the port's unsharded gradient is)."""
    b, t_valid, t_pad = 2, 4544, 5120  # chunk 1280, pad 576 ≥ n_fft/2
    scales, overlap = [512, 256], 0.75
    x = (rng.standard_normal((b, t_valid)) * 0.1).astype(np.float32)
    y = (rng.standard_normal((b, t_valid)) * 0.1).astype(np.float32)

    def jax_unsharded(r):
        return jax_loss(jnp.asarray(x), r, scales, overlap)[0]

    want_jax = float(jax_unsharded(jnp.asarray(y)))
    g_jax = np.asarray(jax.grad(jax_unsharded)(jnp.asarray(y)))
    yt = torch.tensor(y, requires_grad=True)
    want, _, _ = spectral_loss_from_signals(torch.tensor(x), yt, scales, overlap)
    (g_want,) = torch.autograd.grad(want, yt)

    mesh = make_mesh(2, 4)
    axis = mesh.time_axis
    yt = torch.tensor(y, requires_grad=True)
    pad = (0, t_pad - t_valid)
    target = reflect_tail_into_pad(to_time_shards(torch.nn.functional.pad(torch.tensor(x), pad), axis),
                                   t_valid, axis)
    recon = reflect_tail_into_pad(to_time_shards(torch.nn.functional.pad(yt, pad), axis), t_valid, axis)
    got = sharded_multiscale_spec_loss(target, recon, scales, overlap, mesh, t_valid)
    (g_got,) = torch.autograd.grad(got, yt)
    got, want = got.detach(), want.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), want_jax, rtol=1e-5)
    np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), atol=1e-6 * float(g_want.abs().max()))
    # across FFT libraries the gradient's bound is tests/test_torch_spectral_loss.py:83's
    np.testing.assert_allclose(g_got.numpy(), g_jax, atol=1e-4 * float(np.abs(g_jax).max()))


def test_time_sharded_reverb_matches_jax_and_fft_convolve(rng):
    """The overlap-scatter convolution, an IR spanning ~3 shards' chunks,
    against JAX's and the full-signal fft_convolve (atol 2e-3)."""
    b, t, length = 2, 2048, 700
    x = rng.standard_normal((b, t)).astype(np.float32)
    ir = rng.standard_normal((length,)).astype(np.float32)
    ir_padded = np.pad(ir, (0, t - length))
    want = fft_convolve(torch.tensor(x), torch.tensor(ir_padded)[None])
    want_jax = jax.jit(jax_sharded_reverb(jax_make_mesh(data=2, time=4)))(jnp.asarray(x), jnp.asarray(ir))
    for time in (4, 8):
        got = make_time_sharded_reverb(make_mesh(1, time))(torch.tensor(x), torch.tensor(ir))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), atol=2e-3)
    np.testing.assert_allclose(want.numpy(), np.asarray(jax_fft_convolve(
        jnp.asarray(x), jnp.asarray(ir_padded)[None])), atol=2e-3)


def test_shard_batch_and_shard_time_batch():
    """In process the batch is whole; shard_time_batch pads sig to T_pad."""
    mesh = make_mesh(2, 4)
    batch = {"sig": torch.arange(2 * 12, dtype=torch.float32).view(2, 12),
             "pitch": torch.ones(2, 3, 1)}
    assert all(torch.equal(a, b) for a, b in zip(shard_batch(batch, mesh).values(), batch.values()))
    out = shard_time_batch(batch, mesh, t_pad=16)
    assert out["sig"].shape == (2, 16) and torch.equal(out["sig"][:, :12], batch["sig"])
    assert torch.equal(out["pitch"], batch["pitch"])


def test_in_process_data_parallel_step_is_the_unsharded_step(rng):
    """An in-process mesh with time = 1 holds the whole batch: its step is
    the unsharded step, bit for bit (the data-parallel step across
    processes is tests/test_torch_multiproc.py's)."""
    cfg = Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": 2048, "block_size": 64},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 16, "n_harmonic": 4, "n_bands": 5, "sample_rate": 16000,
            "block_size": 64, "has_reverb": False}},
        "train": {"scales": [256, 128], "overlap": 0.75, "batch": 8}})
    batch = {"sig": torch.tensor(rng.standard_normal((8, 2048)).astype(np.float32)),
             "pitch": torch.tensor(rng.uniform(100, 300, (8, 32, 1)).astype(np.float32)),
             "loudness": torch.tensor(rng.standard_normal((8, 32, 1)).astype(np.float32))}
    rows = []
    for mesh in (None, make_mesh(8, 1)):
        model = init_params(DDSPDecoder(16, 4, 5, 16000, 64, False), torch.Generator().manual_seed(0))
        tx = make_optimizer(cfg)
        state = TrainState(0, model, tx.init(list(model.parameters())),
                           torch.Generator().manual_seed(1), 0.0, 1.0)
        metrics = make_train_step(model, tx, cfg, mesh)(state, batch)
        rows.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     [p.detach().clone() for p in model.parameters()]))
    assert rows[0][:2] == rows[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(rows[0][2], rows[1][2]))
