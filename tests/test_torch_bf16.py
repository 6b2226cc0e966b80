"""The port's bf16 model dtype against the JAX package's `dtype=bfloat16`
models on the CPU, at a small width (hidden 32, 8 harmonics, 9 noise bands,
16 kHz, block 64), with transplanted weights and injected noise.  The JAX
functions run compiled (jax.jit), as every path of the JAX package runs
them: XLA then keeps unrounded a bf16 result that only a cast to float32
reads, which the port reproduces (models/decoder.py `dense`).

Tolerances:
  * Dense: bit for bit (bf16 input, kernel and bias, the bias added after
    the product, as flax's nn.Dense(dtype=bf16) does).
  * Every other module, and the slice: a per-element bound in ulps does not
    work.  One float32 ulp of difference upstream (another FFT, exp or sum
    order) flips a bf16 rounding, which the GRU then carries, and a
    near-zero element differs by many ulps.  The gap criterion holds the
    port to bf16's error instead.  With gap = |jax_bf16 − jax_f32| and
    err = |port_bf16 − jax_bf16|, elementwise:
      - mean err ≤ GAP_MEAN (0.25) × mean gap;
      - max err ≤ GAP_MAX (2) × max gap;
      - mean |port_bf16 − jax_f32| within GAP_BAND (0.5–1.5) × mean gap:
        the port carries bf16's error, not float32's answer.
    Measured here: the MLP, the GRU (outputs and carry), the GRUDecoder and
    the encoder's z bit for bit (err 0); the decoder's and autoencoder's
    signals mean err 0.015 and 0.011 of the gap (the float32 synths); the
    streamed audio ≤ 0.023 of it, its carries bit for bit.
  * Gradients: relative L2 to JAX's bf16 gradients ≤ GAP_MEAN × the
    relative L2 between JAX's bf16 and f32 gradients, for the whole
    gradient (measured: 0.012 against a gap of 0.280).
  * Trainer: float32 parameters and optimizer state after a bf16 fit,
    finite losses, and a resumed run bit for bit equal to a straight one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ddsp_pytorch_tpu.export import load_bundle as jax_load_bundle
from ddsp_pytorch_tpu.models.decoder import GRU as JaxGRU
from ddsp_pytorch_tpu.models.decoder import MLP as JaxMLP
from ddsp_pytorch_tpu.models.decoder import DDSPDecoder as JaxDecoder
from ddsp_pytorch_tpu.models.decoder import GRUDecoder as JaxGRUDecoder
from ddsp_pytorch_tpu.models.encoder import DDSPAutoencoder as JaxAutoencoder
from ddsp_pytorch_tpu.streaming import StreamingSynth as JaxStreamingSynth
from ddsp_pytorch_tpu.training.loss import spectral_loss_from_signals as jax_loss
from ddsp_pytorch_tpu.training.train import _normalize_loudness
from ddsp_pytorch_tpu_torch import export
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.inference import render, timbre_transfer, transfer_controls
from ddsp_pytorch_tpu_torch.models import DDSPAutoencoder, DDSPDecoder, load_model
from ddsp_pytorch_tpu_torch.models.decoder import GRU, MLP, GRUDecoder, dense
from ddsp_pytorch_tpu_torch.parallel import LongFormSynthesizer, make_mesh
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.train import loss_and_grads
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict, state_dict_to_flax

KW = dict(hidden_size=32, n_harmonic=8, n_bands=9, sample_rate=16000, block_size=64, has_reverb=True)
H, B, F, N_MFCC = 32, 2, 40, 30
SCALES = [512, 256]
BF16 = jnp.bfloat16
GAP_MEAN, GAP_MAX, GAP_BAND = 0.25, 2.0, (0.5, 1.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_bf16_gap(port, jax_bf16, jax_f32, what=""):
    """The gap criterion of the module docstring."""
    port, want, f32 = _np(port), _np(jax_bf16), _np(jax_f32)
    assert port.shape == want.shape == f32.shape, what
    assert np.all(np.isfinite(port)), what
    gap = np.abs(want - f32)
    err = np.abs(port - want)
    assert gap.mean() > 0, f"{what}: bf16 and f32 agree exactly; the criterion cannot test"
    assert err.mean() <= GAP_MEAN * gap.mean(), (
        f"{what}: mean |port - jax_bf16| {err.mean():.3e} > {GAP_MEAN} x mean gap {gap.mean():.3e}")
    assert err.max() <= GAP_MAX * gap.max(), (
        f"{what}: max |port - jax_bf16| {err.max():.3e} > {GAP_MAX} x max gap {gap.max():.3e}")
    band = np.abs(port - f32).mean() / gap.mean()
    assert GAP_BAND[0] <= band <= GAP_BAND[1], f"{what}: mean |port - jax_f32| / mean gap = {band:.3f}"


def _rel_l2(a: dict, b: dict) -> float:
    x = np.concatenate([a[k].ravel() for k in sorted(b)])
    y = np.concatenate([b[k].ravel() for k in sorted(b)])
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(tree[k], np.float32)


def _init(module, *args):
    params = module.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))["params"]
    return jax.tree.map(np.asarray, params)


def _port(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(params))
    return module.eval()


def _controls(rng, b=B, f=F):
    return (rng.uniform(150, 450, (b, f, 1)).astype(np.float32),
            rng.standard_normal((b, f, 1)).astype(np.float32))


# ---------------------------------------------------------------- modules


def test_dense_is_bitwise_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, F, 48)).astype(np.float32)
    layer = fnn.Dense(H, dtype=BF16)
    params = _init(layer, x)
    params["bias"] = rng.standard_normal(H).astype(np.float32)  # a nonzero bias
    want = jax.jit(layer.apply)({"params": params}, jnp.asarray(x))
    port = _port(torch.nn.Linear(48, H), params)
    with torch.no_grad():
        got = dense(port, torch.tensor(x), torch.bfloat16)
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_mlp():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, F, 1)).astype(np.float32) * 3.0
    params = _init(JaxMLP(H, dtype=BF16), x)
    want = jax.jit(JaxMLP(H, dtype=BF16).apply)({"params": params}, jnp.asarray(x))
    ref = jax.jit(JaxMLP(H).apply)({"params": params}, jnp.asarray(x))
    port = _port(MLP(1, H, compute_dtype=torch.bfloat16), params)
    with torch.no_grad():
        got = port(torch.tensor(x))
    assert got.dtype == torch.bfloat16
    assert_bf16_gap(got, want, ref, "MLP")


def test_gru_outputs_and_carry():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, F, 48)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    params = _init(JaxGRU(H, dtype=BF16), x)
    want, want_h = jax.jit(JaxGRU(H, dtype=BF16).apply)({"params": params}, jnp.asarray(x), jnp.asarray(h0))
    ref, ref_h = jax.jit(JaxGRU(H).apply)({"params": params}, jnp.asarray(x), jnp.asarray(h0))
    port = _port(GRU(48, H, torch.bfloat16), params)
    with torch.no_grad():
        got, got_h = port(torch.tensor(x), torch.tensor(h0))
    assert got_h.dtype == torch.bfloat16
    assert_bf16_gap(got, want, ref, "GRU outputs")
    assert_bf16_gap(got_h, want_h, ref_h, "GRU carry")


@pytest.mark.parametrize("z_dim", [None, 16], ids=["decoder", "with_z"])
def test_gru_decoder(z_dim):
    rng = np.random.default_rng(3)
    f0, loud = _controls(rng)
    z = rng.standard_normal((B, F, 16)).astype(np.float32) if z_dim else None
    args = [jnp.asarray(f0), jnp.asarray(loud)] + ([jnp.asarray(z)] if z_dim else [])
    jm, jref = JaxGRUDecoder(H, z_dim=z_dim, dtype=BF16), JaxGRUDecoder(H, z_dim=z_dim)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), *args)["params"])
    want = jax.jit(jm.apply)({"params": params}, *args)
    ref = jax.jit(jref.apply)({"params": params}, *args)
    port = _port(GRUDecoder(H, z_dim=z_dim, compute_dtype=torch.bfloat16), params)
    with torch.no_grad():
        got, _ = port(torch.tensor(f0), torch.tensor(loud), z=None if z is None else torch.tensor(z))
    assert_bf16_gap(got, want, ref, "GRUDecoder")


# ----------------------------------------------------------------- models


def _decoder_params(rng):
    f0, loud = _controls(rng)
    batch = {"pitch": jnp.asarray(f0), "loudness": jnp.asarray(loud)}
    params = JaxDecoder(**KW, dtype=BF16).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, batch)["params"]
    params = jax.tree.map(np.asarray, params)
    # reverb away from its init, so its decay and wet matter
    params["reverb"] = dict(params["reverb"], decay=np.float32(1.3), wet=np.float32(-0.7))
    return params, {"pitch": f0, "loudness": loud}


def _forward(model, params, batch, key):
    return jax.jit(lambda p, b: model.apply({"params": p}, b, rngs={"noise": key}))(params, batch)


def test_load_model_dtype_keeps_float32_parameters():
    for name in ("single-inst-decoder", "mfcc-autoencoder"):
        model = load_model(name, dict(KW, dtype="bfloat16"))
        assert model.compute_dtype == torch.bfloat16
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        assert model.dtype == torch.float32
        for dtype in ("float32", None):
            assert load_model(name, dict(KW, dtype=dtype)).compute_dtype is None
    with pytest.raises(ValueError, match="float16"):
        load_model("single-inst-decoder", dict(KW, dtype="float16"))


def test_decoder_forward_signal():
    rng = np.random.default_rng(4)
    params, batch = _decoder_params(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    jm = JaxDecoder(**KW, dtype=BF16, use_pallas="never")
    noise = jm.apply({"params": params}, jbatch["pitch"], method=jm.sample_noise, rngs={"noise": key})
    want = _forward(jm, params, jbatch, key)
    ref = _forward(JaxDecoder(**KW, use_pallas="never"), params, jbatch, key)
    port = _port(DDSPDecoder(**KW, compute_dtype=torch.bfloat16), params)
    with torch.no_grad():
        got = port({k: torch.tensor(v) for k, v in batch.items()}, noise=torch.tensor(np.asarray(noise)))
    assert got["signal"].dtype == torch.float32
    assert_bf16_gap(got["signal"], want["signal"], ref["signal"], "DDSPDecoder signal")


def test_autoencoder_forward_signal():
    rng = np.random.default_rng(5)
    f0, loud = _controls(rng)
    mfcc = (10.0 * rng.standard_normal((B, F, N_MFCC))).astype(np.float32)
    batch = {"pitch": f0, "loudness": loud, "mfcc": mfcc}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(6)
    jm = JaxAutoencoder(**KW, dtype=BF16, use_pallas="never")
    params = jax.tree.map(np.asarray, jm.init({"params": jax.random.PRNGKey(0), "noise": key}, jbatch)["params"])
    noise = jm.apply({"params": params}, jbatch["pitch"], method=jm.sample_noise, rngs={"noise": key})
    want = _forward(jm, params, jbatch, key)
    ref = _forward(JaxAutoencoder(**KW, use_pallas="never"), params, jbatch, key)
    port = _port(DDSPAutoencoder(**KW, compute_dtype=torch.bfloat16), params)
    with torch.no_grad():
        got = port({k: torch.tensor(v) for k, v in batch.items()}, noise=torch.tensor(np.asarray(noise)))
    assert_bf16_gap(got["z"], want["z"], ref["z"], "DDSPAutoencoder z")
    assert_bf16_gap(got["signal"], want["signal"], ref["signal"], "DDSPAutoencoder signal")


def test_streaming_step_blocks():
    """5 chained streaming_steps of 8 frames from a zero float32 carry:
    audio and GRU carry after each, against JAX's bf16 and f32 steps."""
    rng = np.random.default_rng(7)
    params, batch = _decoder_params(rng)
    jm, jref = JaxDecoder(**KW, dtype=BF16, use_pallas="never"), JaxDecoder(**KW, use_pallas="never")
    steps = {name: jax.jit(lambda p, *a, m=m: m.apply({"params": p}, *a, method=m.streaming_step))
             for name, m in (("bf16", jm), ("f32", jref))}
    port = _port(DDSPDecoder(**KW, compute_dtype=torch.bfloat16), params)
    carries = {"bf16": (jnp.zeros((B, H)), jnp.zeros(B)), "f32": (jnp.zeros((B, H)), jnp.zeros(B))}
    t_gru, t_phase = torch.zeros(B, H), torch.zeros(B)
    for c in range(5):
        sl = slice(8 * c, 8 * (c + 1))
        args = (jnp.asarray(batch["pitch"][:, sl]), jnp.asarray(batch["loudness"][:, sl]))
        noise = rng.uniform(-1, 1, (B, 8, KW["block_size"])).astype(np.float32)
        out = {}
        for name in ("bf16", "f32"):
            audio, gru, phase = steps[name](params, *args, *carries[name], jnp.asarray(noise))
            carries[name] = (gru, phase)
            out[name] = audio
        with torch.no_grad():
            audio, t_gru, t_phase = port.streaming_step(
                torch.tensor(batch["pitch"][:, sl]), torch.tensor(batch["loudness"][:, sl]),
                t_gru, t_phase, torch.tensor(noise))
        assert_bf16_gap(audio, out["bf16"], out["f32"], f"block {c} audio")
        assert_bf16_gap(t_gru, carries["bf16"][0], carries["f32"][0], f"block {c} GRU carry")


def test_train_step_loss_and_gradients():
    """One step's loss_and_grads against jax.value_and_grad of the JAX
    train step's loss, bf16 and f32."""
    rng = np.random.default_rng(8)
    params, batch = _decoder_params(rng)
    t = np.arange(F * KW["block_size"]) / KW["sample_rate"]
    batch["sig"] = (0.3 * np.sin(2 * np.pi * 220.0 * t)[None]
                    + 0.02 * rng.standard_normal((B, t.size))).astype(np.float32)
    batch["loudness"] = batch["loudness"] - 6.0
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mean, std, key = -6.0, 1.1, jax.random.PRNGKey(3)

    def value_and_grad(m):
        def loss_fn(p):
            out = m.apply({"params": p}, _normalize_loudness(jbatch, mean, std), rngs={"noise": key})
            return jax_loss(jbatch["sig"], out["signal"], SCALES, 0.75)[0]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
        return float(loss), dict(_leaves(jax.tree.map(np.asarray, grads)))

    jm = JaxDecoder(**KW, dtype=BF16, use_pallas="never")
    want_loss, want = value_and_grad(jm)
    ref_loss, ref = value_and_grad(JaxDecoder(**KW, use_pallas="never"))
    noise = jm.apply({"params": params}, jbatch["pitch"], method=jm.sample_noise, rngs={"noise": key})
    port = _port(DDSPDecoder(**KW, compute_dtype=torch.bfloat16), params).train()
    loss, grads = loss_and_grads(port, {k: torch.tensor(v) for k, v in batch.items()}, mean, std,
                                 SCALES, 0.75, noise=torch.tensor(np.asarray(noise)))
    assert all(g.dtype == torch.float32 for g in grads)
    names = [n for n, _ in port.named_parameters()]
    got = dict(_leaves(state_dict_to_flax(dict(zip(names, grads)))))
    assert_bf16_gap(np.float32(loss), np.float32(want_loss), np.float32(ref_loss), "loss")
    gap = _rel_l2(want, ref)
    err = _rel_l2(got, want)
    assert gap > 0 and err <= GAP_MEAN * gap, f"gradient rel L2 {err:.3e} > {GAP_MEAN} x gap {gap:.3e}"


# ------------------------------------------------------------------ slice


def _tiny_config(cache: str, **train) -> Config:
    return Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": 8192, "block_size": 64, "out_dir": cache,
                       "pitch_tracker": "yin"},
        "model": {"name": "single-inst-decoder", "kwargs": dict(KW, dtype="bfloat16")},
        "train": {"scales": SCALES, "batch": 2, "steps": 6, "val_interval_epochs": 0,
                  "checkpoint_every_steps": 3, **train},
    })


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16_run")
    cache = str(root / "cache")
    make_synthetic_dataset(cache, n_items=4, sample_rate=16000, signal_length=8192, block_size=64,
                           n_harmonic=8, device="cpu")
    return root, cache


def _fit(cfg, run_dir, totals):
    state = None
    for total in totals:
        dm = Datamodule(cfg)
        dm.setup()
        trainer = Trainer(cfg, run_dir, device="cpu", use_tensorboard=False)
        assert trainer.model.compute_dtype == torch.bfloat16
        state = trainer.fit(dm, total_steps=total)
        trainer.close()
    return state


def test_trainer_bf16_keeps_float32_and_resumes_bitwise(bf16_run):
    root, cache = bf16_run
    cfg = _tiny_config(cache)
    a = _fit(cfg, str(root / "straight"), [6])
    b = _fit(cfg, str(root / "resumed"), [3, 6])
    assert a.step == b.step == 6
    for (k, va), (_, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert va.dtype == torch.float32, k
        assert torch.equal(va, vb), k
    for x, y in zip(jax.tree.leaves(a.opt_state), jax.tree.leaves(b.opt_state)):
        assert x.dtype in (torch.float32, torch.int32, torch.int64) and torch.equal(x, y)
    la = read_metrics(str(root / "straight"), "loss")
    assert la == read_metrics(str(root / "resumed"), "loss")
    assert len(la) == 6 and all(np.isfinite(v) for _, v in la)


@pytest.fixture(scope="module")
def bf16_bundle(bf16_run):
    """A bf16 run of 4 steps, exported."""
    root, cache = bf16_run
    run_dir = str(root / "export_run")
    _fit(_tiny_config(cache, steps=4, checkpoint_every_steps=0), run_dir, [4])
    return export.export_run(run_dir, str(root / "export"), device="cpu")


def test_bf16_export_streams_in_jax(bf16_bundle):
    """The port's bf16 bundle: meta.json says bfloat16, the JAX package
    loads it, and the port's stream holds to the gap criterion against
    the JAX bf16 stream, the JAX f32 stream of the same parameters being
    the reference (noise off, 6 blocks of 4 frames)."""
    bundle = bf16_bundle
    with open(os.path.join(bundle, "meta.json")) as f:
        assert json.load(f)["model"]["kwargs"]["dtype"] == "bfloat16"
    jmodel, jparams, jcfg = jax_load_bundle(bundle)
    assert jmodel.dtype == BF16
    stats = dict(mean_loudness=jcfg.data.mean_loudness, std_loudness=jcfg.data.std_loudness,
                 noise_deterministic=True)
    want_synth = JaxStreamingSynth(jmodel, jparams, **stats)
    ref_synth = JaxStreamingSynth(jmodel.clone(dtype=jnp.float32), jparams, **stats)
    port = export.make_streaming_synth(bundle, device="cpu", noise_deterministic=True)
    assert port.model.compute_dtype == torch.bfloat16
    rng = np.random.default_rng(9)
    got, want, ref = [], [], []
    for _ in range(6):
        f0, loud = _controls(rng, b=1, f=4)
        loud = loud + jcfg.data.mean_loudness
        got.append(port.step(f0, loud).numpy())
        want.append(np.asarray(want_synth.step(f0, loud)))
        ref.append(np.asarray(ref_synth.step(f0, loud)))
        assert port.state.gru.dtype == torch.float32
    assert_bf16_gap(np.concatenate(got, 1), np.concatenate(want, 1), np.concatenate(ref, 1),
                    "bundle stream")


def test_bf16_bundle_renders_long_form_and_transfer(bf16_bundle):
    """A bf16 bundle through LongFormSynthesizer (2 time shards, noise off)
    equals its unsharded forward (the long-form tests' 2e-3), and through
    timbre_transfer (its YIN tracker) renders bf16's answer: finite, within
    5e-2 of the float32 render's peak and not equal to it."""
    model, _ = export.load_bundle(bf16_bundle, device="cpu")
    config = Config.from_yaml(os.path.join(bf16_bundle, "config.yaml"))
    rng = np.random.default_rng(10)
    f0, loud = (torch.tensor(a) for a in _controls(rng, b=2, f=32))
    noise = torch.zeros(2, 32, KW["block_size"])
    got = LongFormSynthesizer(model, make_mesh(1, 2)).synthesize(f0, loud, noise=noise)
    with torch.no_grad():
        want = model({"pitch": f0, "loudness": loud}, noise=noise)["signal"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)

    t = np.arange(4096) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    out = timbre_transfer(bf16_bundle, audio, 16000, noise_deterministic=True, device="cpu")
    f0_t, loud_t, _ = transfer_controls(config, audio, device="cpu")
    f32 = render(_as_float32(model), config, f0_t, loud_t, noise_deterministic=True, device="cpu")
    assert out.shape == f32.shape == (4096,) and np.all(np.isfinite(out))
    peak = np.abs(f32).max()
    assert peak > 0 and 0 < np.abs(out - f32).max() <= 5e-2 * peak


def _as_float32(model):
    other = load_model("single-inst-decoder", dict(KW, dtype="float32"))
    other.load_state_dict(model.state_dict())
    return other.eval()
