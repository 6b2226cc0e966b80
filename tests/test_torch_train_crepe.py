"""CREPE training in the port (ddsp_pytorch_tpu_torch/models/crepe.py in
train mode, ddsp_pytorch_tpu_torch/train_crepe.py) against the JAX
package's CREPE and scripts/train_crepe.py, on the CPU.

Tolerances:
  * synth_batch fed the JAX script's draws: frames within 1e-5 and f0 equal
    (both add the phase in XLA's CPU scan order, scan_cumsum);
  * f0_to_target within 5e-5: the cents (~9000 above 10 Hz) come from two
    float32 log2 implementations, one ulp (9.8e-4 cents) apart, which
    moves a target exp(−½((g − c)/25)²) by up to 2.4e-5; the weighted BCE
    of the same targets within 1e-6 relative;
  * one train-mode step in float64 at micro capacity, batch 8, the same
    dropout masks on both sides: the loss and every gradient leaf within
    1e-6 of the leaf's largest magnitude (the JAX CREPE rounds its logits
    to float32), the updated batch_stats within 1e-10;
  * the saved bundle restored by flax: the JAX CREPE's salience equals the
    port's within 1e-5, and load_crepe reads it back bit for bit.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
from flax import serialization

from ddsp_pytorch_tpu.models import crepe as J
from ddsp_pytorch_tpu_torch.models import crepe as P
from ddsp_pytorch_tpu_torch import train_crepe as T
from ddsp_pytorch_tpu_torch.training.optim import Optimizer
from ddsp_pytorch_tpu_torch.weights import crepe_state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_ATOL = 1e-5
TARGET_ATOL = 5e-5
BCE_REL = 1e-6
GRAD_REL = 1e-6
STATS_ATOL = 1e-10
SALIENCE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("_scripts_train_crepe",
                                                  os.path.join(ROOT, "scripts", "train_crepe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_draws(rng, batch: int, robust: bool) -> dict:
    """The draws scripts/train_crepe.py's synth_batch makes from `rng`, named
    as the port's draw_synth_inputs names them."""
    (k_f0, k_amp, k_phase, k_noise, k_snr, k_gain, k_vib, k_vibp, k_form, k_fg, k_fw, k_coh,
     k_color, k_rev, k_revg, k_revm, k_revon, k_clip, k_clipd) = jax.random.split(rng, 19)
    u = jax.random.uniform
    draws = {
        "f0": jnp.exp(u(k_f0, (batch,), minval=math.log(40.0), maxval=math.log(1800.0))),
        "alpha": u(k_amp, (batch, 1), minval=0.5, maxval=2.5),
        "formant_pos": u(k_form, (batch, 1), minval=2.0, maxval=8.0),
        "formant_gain_exp": u(k_fg, (batch, 1), maxval=1.1),
        "formant_width": u(k_fw, (batch, 1), minval=0.8, maxval=2.5),
        "phases": u(k_phase, (batch, 16), maxval=2.0 * math.pi),
        "coherent": jax.random.bernoulli(k_coh, 0.5, (batch, 1)),
        "vib_depth": u(k_vib, (batch, 1), maxval=0.01),
        "vib_phase": u(k_vibp, (batch, 1), maxval=2.0 * math.pi),
        "noise": jax.random.normal(k_noise, (batch, 1024)),
        "snr_db": u(k_snr, (batch, 1), minval=-2.0 if robust else 5.0, maxval=40.0),
        "gain_exp": u(k_gain, (batch, 1), minval=-2.0, maxval=0.0),
    }
    if robust:
        draws.update({
            "delays": jax.random.randint(k_rev, (batch, 4), 16, 500),
            "signs": jax.random.rademacher(k_revm, (batch, 4), dtype=jnp.float32),
            "tap_gains": u(k_revg, (batch, 4), minval=0.15, maxval=0.5),
            "use_rev": jax.random.bernoulli(k_revon, 0.5, (batch, 1)),
            "use_pink": jax.random.bernoulli(k_color, 0.5, (batch, 1)),
            "drive": u(k_clipd, (batch, 1), minval=1.5, maxval=4.0),
            "use_clip": jax.random.bernoulli(k_clip, 0.3, (batch, 1)),
        })
    out = {}
    for name, value in draws.items():
        arr = np.asarray(value)
        out[name] = torch.tensor(arr.astype(np.int64) if name == "delays" else arr)
    return out


def test_scan_cumsum_equals_jnp_cumsum_bitwise():
    rng = np.random.default_rng(0)
    for n in (1, 15, 16, 17, 300, 1024, 4100):
        x = rng.uniform(40.0, 1800.0, (3, n)).astype(np.float32)
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
        np.testing.assert_array_equal(T.scan_cumsum(torch.tensor(x)).numpy(), want)


@pytest.mark.parametrize("robust", [False, True], ids=["clean", "robust"])
def test_synth_batch_fed_jax_draws_matches_jax(script, robust):
    rng = jax.random.PRNGKey(3)
    want_frames, want_f0 = script.synth_batch(rng, 32, robust=robust)
    frames, f0 = T.synth_batch(jax_draws(rng, 32, robust), robust)
    assert frames.shape == (32, 1024) and frames.dtype == torch.float32
    np.testing.assert_array_equal(f0.numpy(), np.asarray(want_f0))
    np.testing.assert_allclose(frames.numpy(), np.asarray(want_frames), atol=SYNTH_ATOL, rtol=0)


@pytest.mark.parametrize("robust", [False, True], ids=["clean", "robust"])
def test_draws_have_the_jax_shapes_and_ranges(robust):
    """The port's draws have the names, shapes and dtypes of the script's,
    and both lie in the script's ranges."""
    ranges = {"f0": (40.0, 1800.0), "alpha": (0.5, 2.5), "formant_pos": (2.0, 8.0),
              "formant_gain_exp": (0.0, 1.1), "formant_width": (0.8, 2.5), "phases": (0.0, 2.0 * math.pi),
              "vib_depth": (0.0, 0.01), "vib_phase": (0.0, 2.0 * math.pi),
              "snr_db": (-2.0 if robust else 5.0, 40.0), "gain_exp": (-2.0, 0.0), "delays": (16, 499),
              "signs": (-1.0, 1.0), "tap_gains": (0.15, 0.5), "drive": (1.5, 4.0)}
    draws = T.draw_synth_inputs(64, torch.Generator().manual_seed(0), robust)
    want = jax_draws(jax.random.PRNGKey(0), 64, robust)
    assert set(draws) == set(want)
    for name, value in want.items():
        got = draws[name]
        assert got.shape == value.shape and got.dtype == value.dtype, name
        if name in ranges:
            lo, hi = ranges[name]
            for side in (got, value):  # float32 rounding at the bounds aside
                assert lo - 1e-6 * max(1.0, abs(lo)) <= float(side.min()), name
                assert float(side.max()) <= hi + 1e-6 * max(1.0, abs(hi)), name
    if robust:
        assert set(draws["signs"].unique().tolist()) == {-1.0, 1.0}
    frames, _ = T.synth_batch(draws, robust)
    assert torch.isfinite(frames).all()


def test_f0_to_target_and_weighted_bce_match_jax(script):
    rng = np.random.default_rng(1)
    f0 = rng.uniform(40.0, 1800.0, 16).astype(np.float32)
    want = np.asarray(script.f0_to_target(jnp.asarray(f0)))
    target = T.f0_to_target(torch.tensor(f0))
    np.testing.assert_allclose(target.numpy(), want, atol=TARGET_ATOL)
    logits = rng.standard_normal((16, 360)).astype(np.float32) * 4.0
    z, y = jnp.asarray(logits), jnp.asarray(want)
    want_loss = float(jnp.mean(20.0 * y * jax.nn.softplus(-z) + (1.0 - y) * jax.nn.softplus(z)))
    got = float(T.weighted_bce(torch.tensor(logits), torch.tensor(want), 20.0))
    assert abs(got - want_loss) <= BCE_REL * abs(want_loss)


def _masks_flax_layout(model: P.CREPE, batch: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(b, t, c)) < 1.0 - P.DROPOUT_RATE for b, c, t in model.block_shapes(batch)]


def _jax_train_step(tree, frames, target, masks, pos_weight):
    """(loss, grads, new batch_stats) of the JAX CREPE in train mode, its
    dropout masks replaced by `masks` (flax's (B, T, C) layout)."""
    model = J.CREPE(capacity="micro", dtype=jnp.float64)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            i = int(context.module.name.split("_")[-1])
            x = args[0]
            keep = 1.0 - context.module.rate
            return jnp.where(jnp.asarray(masks[i]), x / keep, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    def loss_fn(params):
        with fnn.intercept_methods(interceptor):
            logits, updates = model.apply({"params": params, "batch_stats": tree["batch_stats"]},
                                          frames, train=True, mutable=["batch_stats"])
        logits = logits.astype(jnp.float64)
        bce = pos_weight * target * jax.nn.softplus(-logits) + (1.0 - target) * jax.nn.softplus(logits)
        return jnp.mean(bce), updates["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(tree["params"])
    return float(loss), jax.tree_util.tree_map(np.asarray, grads), jax.tree_util.tree_map(np.asarray, stats)


def _flax_layout(named: dict) -> dict:
    """A CREPE state_dict (or {name: gradient}) as flax's {params,
    batch_stats} tree of numpy arrays, their dtype kept (float64 here)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in named.items():
        layer, leaf = key.split(".")
        arr = value.detach().numpy()
        if leaf.startswith("running_"):
            tree["batch_stats"].setdefault(layer, {})[leaf[len("running_"):]] = arr
        elif leaf == "weight":
            tree["params"].setdefault(layer, {})["kernel" if arr.ndim > 1 else "scale"] = arr.T
        else:
            tree["params"].setdefault(layer, {})["bias"] = arr
    return tree


def test_float64_train_step_matches_jax_with_injected_masks():
    gen = torch.Generator().manual_seed(5)
    model = T.init_crepe(P.CREPE("micro"), gen)
    # non-trivial running statistics, so their update is visible
    for i in range(1, 7):
        bn = getattr(model, f"bn{i}")
        bn.running_mean.uniform_(-0.5, 0.5, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    model = model.double()
    frames, f0 = T.synth_batch(T.draw_synth_inputs(8, gen))
    frames, target = frames.double(), T.f0_to_target(f0.double())
    masks = _masks_flax_layout(model, 8, seed=2)
    tree = _flax_layout(model.state_dict())
    with jax.enable_x64(True):
        want_loss, want_grads, want_stats = _jax_train_step(
            tree, jnp.asarray(frames.numpy()), jnp.asarray(target.numpy()), masks, 20.0)

    tx = Optimizer("adam", 2e-3)
    loss, grads, _ = T.train_step(model, tx, tx.init(list(model.parameters())), frames, target, 20.0,
                                  dropout_masks=[torch.tensor(m).transpose(1, 2) for m in masks])
    assert abs(float(loss) - want_loss) <= GRAD_REL * abs(want_loss)
    got_grads = _flax_layout({n: g for (n, _), g in zip(model.named_parameters(), grads)})["params"]
    assert got_grads.keys() == want_grads.keys()
    for layer, leaves in want_grads.items():
        assert got_grads[layer].keys() == leaves.keys()
        for leaf, want in leaves.items():
            got = got_grads[layer][leaf]
            assert got.shape == want.shape and got.dtype == np.float64
            err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
            assert err <= GRAD_REL, (layer, leaf, err)
    for layer, stats in want_stats.items():
        bn = getattr(model, layer)
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=STATS_ATOL, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=STATS_ATOL, rtol=0)


def test_train_mode_needs_masks_or_a_generator_and_eval_is_unchanged():
    model = T.init_crepe(P.CREPE("micro"), torch.Generator().manual_seed(0))
    frames = torch.randn(4, 1024, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="dropout_masks or a generator"):
        model(frames, train=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        a = model(frames)
        b = model(frames, train=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    gen = torch.Generator().manual_seed(2)
    model(frames, train=True, generator=gen)
    assert not torch.equal(model.bn1.running_mean, before["bn1.running_mean"])


def test_saved_bundle_restores_in_flax_and_load_crepe(tmp_path):
    model, log = T.train("micro", steps=3, batch=8, log_every=2, device="cpu")
    assert [r["step"] for r in log] == [1, 2] and all(np.isfinite(r["loss"]) for r in log)
    path = tmp_path / "crepe_micro.msgpack"
    path.write_bytes(T.crepe_bytes(model))
    restored = serialization.msgpack_restore(path.read_bytes())
    frames, _ = T.synth_batch(T.draw_synth_inputs(6, torch.Generator().manual_seed(4)))
    want = np.asarray(jax.nn.sigmoid(J.CREPE(capacity="micro").apply(restored, jnp.asarray(frames.numpy()))))
    with torch.no_grad():
        got = torch.sigmoid(model(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=SALIENCE_ATOL, rtol=0)
    loaded = P.load_crepe(str(path), device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    assert set(crepe_state_dict_from_flax(restored)) == set(model.state_dict())


def test_cli_writes_a_bundle(tmp_path):
    out = tmp_path / "c.msgpack"
    T.main(["--capacity", "micro", "--steps", "2", "--batch", "4", "--robust", "--out", str(out),
            "--device", "cpu"])
    assert P.load_crepe(str(out), device="cpu").capacity == "micro"
