"""The plain reference against the port's CPU path at a tiny size: the
training forward, loss and gradients in float64, and streamed audio."""

import numpy as np
import pytest
import torch

from benchmark.lib import judge
from benchmark.lib.corpus import loudness_stats, make_corpus
from benchmark.lib.weights import make_weights
from benchmark.reference import ddsp
from benchmark.tests.tiny import tiny_cfg

CPU = torch.device("cpu")


def _program_model(cfg, weights, dtype):
    from ddsp_pytorch_tpu_torch.models import load_model

    m = cfg["model"]
    model = load_model(m["name"], {k: v for k, v in m.items() if k != "name"})
    model.load_state_dict(weights)
    return model.to(dtype)


@pytest.mark.parametrize("model", ["single-inst-decoder", "mfcc-autoencoder"])
def test_train_step_matches_the_port_in_float64(model):
    from ddsp_pytorch_tpu_torch.training.train import loss_and_grads

    cfg = tiny_cfg(model)
    w = make_weights(cfg, 7, CPU)
    corpus = make_corpus(cfg, 4, 7, CPU)
    mean, std = loudness_stats(corpus)
    batch = {"sig": corpus.signals[:2], "pitch": corpus.pitchs[:2, :, None],
             "loudness": corpus.loudness[:2, :, None]}
    if corpus.mfccs is not None:
        batch["mfcc"] = corpus.mfccs[:2, :-1]
    batch = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in batch.items()}
    noise = torch.rand((2, 32, 256), generator=torch.Generator().manual_seed(3), dtype=torch.float64) * 2 - 1
    prog = _program_model(cfg, w, torch.float64)
    names = [n for n, _ in prog.named_parameters()]
    loss, grads = loss_and_grads(prog, batch, mean, std, cfg["train"]["scales"], 0.75, noise=noise)
    losses, g1, _ = ddsp.train_steps({k: v.double() for k, v in w.items()}, cfg, [batch], [noise], mean, std)
    assert abs(float(loss) - losses[0]) < 1e-9 * abs(losses[0])
    assert judge.leaf_gap(dict(zip(names, grads)), g1, names) < 1e-6


@pytest.mark.parametrize("model", ["single-inst-decoder", "mfcc-autoencoder"])
def test_streamed_audio_matches_the_reference(model):
    """The port's StreamingSynth (zero noise) over blocks, against one
    offline pass of the reference; for the autoencoder with the port's
    causal MFCC against the reference's offline frames."""
    from ddsp_pytorch_tpu_torch.streaming import StreamingMFCC, StreamingSynth

    cfg = tiny_cfg(model)
    m, pre = cfg["model"], cfg["preprocess"]
    w = make_weights(cfg, 9, CPU)
    synth = StreamingSynth(_program_model(cfg, w, torch.float32), -30.0, 8.0, noise_deterministic=True,
                           device="cpu")
    n = 12
    rng = np.random.default_rng(0)
    f0 = rng.uniform(100, 500, n).astype(np.float32)
    loud = rng.uniform(-50, -10, n).astype(np.float32)
    audio_in = (0.1 * rng.standard_normal(n * 256)).astype(np.float32)
    mf = None
    if model == "mfcc-autoencoder":
        sm = StreamingMFCC(16000, n_fft=512, hop_length=256, ref_db=0.0)
        frames = np.concatenate([sm.push(audio_in[None, i * 256:(i + 1) * 256])[0] for i in range(n)])
        k = frames.shape[0]
        out = np.concatenate([synth.step(f0[None, i:i + 1, None], loud[None, i:i + 1, None],
                                         frames[None, i:i + 1]).numpy()[0] for i in range(k)])
        mf = ddsp.mfcc_frames(torch.as_tensor(audio_in, dtype=torch.float64)[None], pre, k)
        assert np.abs(frames - mf[0].numpy()).max() < 1e-3 * np.abs(mf[0].numpy()).max()
    else:
        k = n
        out = np.concatenate([synth.step(f0[None, i:i + 1, None], loud[None, i:i + 1, None]).numpy()[0]
                              for i in range(k)])
    p = {kk: v.double() for kk, v in w.items()}
    t = lambda x: torch.as_tensor(x[:k], dtype=torch.float64)[None, :, None]  # noqa: E731
    ref = ddsp.stream_render(p, cfg, t(f0), (t(loud) + 30.0) / 8.0, torch.zeros((1, k, 256), dtype=torch.float64),
                             [1] * k, mf).numpy()[0]
    assert np.abs(out - ref).max() < 1e-4 * np.abs(ref).max()
