"""The user journey through the port's five CLIs (port of scripts/e2e_smoke.sh):

    python -m ddsp_pytorch_tpu_torch.e2e_smoke [--device cuda]

On a tiny generated corpus (three 2 s vibrato tones for training, one for
validation, 16 kHz, written as wavs) and a tiny config (hidden 64, 8
harmonics, 17 bands, block 256, reverb, scales [512, 256], batch 2, 20
steps), each CLI runs in its own process and must exit 0 and leave its
artifacts behind:

  1. python -m ddsp_pytorch_tpu_torch.preprocess   → cache/{train,validation}/signals.npy
  2. python -m ddsp_pytorch_tpu_torch.train --no-mesh --no-tensorboard
                                                   → runs/smoke/config.yaml, runs/smoke/best/
  3. python -m ddsp_pytorch_tpu_torch.export        → export/*_bundle/{params.msgpack,meta.json},
                                                        export/*_impulse.wav
  4. python -m ddsp_pytorch_tpu_torch.transfer      → transfer.wav (timbre transfer of the
                                                        validation tone), not empty
  5. python -m ddsp_pytorch_tpu_torch.performance --bundle B --n-run 2

--device is passed to every step.  The train step runs without the
TensorBoard sink: the journey checks the CLIs' artifacts, and where
`tensorboard` is installed its import loads TensorFlow into the child (the
sink has tests of its own, tests/test_torch_tensorboard.py).  The config
is the JAX script's YAML text, `use_pallas: never` included: the port
reads it and drops it (it chooses the oscillator by the tensors' device,
models/__init__.py load_model).  Everything is written under a temporary
directory, removed at the end.  The device defaults to the GPU and there is no fallback:
--device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.trainrun import child_env
from ddsp_pytorch_tpu_torch.utils.audio_io import save_wav

SAMPLE_RATE, SECONDS = 16000, 2.0
STEP_TIMEOUT_S = 600

CONFIG = """
data:
  data_location: {tmp}/corpus
  extension: wav
preprocess:
  sample_rate: {sr}
  signal_length: 16384
  block_size: 256
  out_dir: {tmp}/cache
model:
  name: single-inst-decoder
  kwargs:
    hidden_size: 64
    n_harmonic: 8
    n_bands: 17
    sample_rate: {sr}
    block_size: 256
    has_reverb: true
    use_pallas: never
train:
  scales: [512, 256]
  overlap: 0.75
  batch: 2
  steps: 20
  lr: 1.0e-3
"""


def write_corpus(tmp: str) -> str:
    """The JAX script's corpus (e2e_smoke.sh:19-49) and its config under
    `tmp`; returns the config's path."""
    sr = SAMPLE_RATE
    rng = np.random.default_rng(0)
    for part, count in (("train", 3), ("validation", 1)):
        d = os.path.join(tmp, "corpus", part)
        os.makedirs(d)
        for i in range(count):
            t = np.arange(int(sr * SECONDS)) / sr
            f0 = 200.0 + 40.0 * i + 6.0 * np.sin(2 * np.pi * 2.5 * t)  # vibrato
            phase = 2 * np.pi * np.cumsum(f0) / sr
            x = np.zeros_like(t)
            for k, a in enumerate([0.5, 0.25, 0.12, 0.08], start=1):
                x += a * np.sin(k * phase)
            env = np.minimum(1.0, t * 8) * np.exp(-t * 0.4)
            x = (x * env + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
            save_wav(os.path.join(d, f"tone{i}.wav"), 0.5 * x, sr)
    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        f.write(CONFIG.format(tmp=tmp, sr=sr))
    return path


def _require(path: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(f"e2e smoke: {path} was not written")
    return path


def run_step(label: str, module: str, *args: str) -> float:
    """`python -m ddsp_pytorch_tpu_torch.<module> args` in its own process;
    raises if it does not exit 0.  Returns its seconds."""
    print(f"== {label}: python -m ddsp_pytorch_tpu_torch.{module} {' '.join(args)}", flush=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", f"ddsp_pytorch_tpu_torch.{module}", *args], env=child_env(),
                   check=True, timeout=STEP_TIMEOUT_S)
    return time.perf_counter() - t0


def journey(tmp: str, device: str) -> dict:
    """The five steps under `tmp`; returns each step's seconds."""
    cfg = write_corpus(tmp)
    dev = ["--device", device]
    secs = {}
    secs["preprocess"] = run_step("1/5 preprocess", "preprocess", "--config", cfg, *dev)
    _require(os.path.join(tmp, "cache", "train", "signals.npy"))
    _require(os.path.join(tmp, "cache", "validation", "signals.npy"))

    runs = os.path.join(tmp, "runs")
    secs["train"] = run_step("2/5 train", "train", "--config", cfg, "--name", "smoke", "--root", runs,
                             "--no-mesh", "--no-tensorboard", *dev)
    _require(os.path.join(runs, "smoke", "config.yaml"))
    if not os.path.isdir(os.path.join(runs, "smoke", "best")):
        raise FileNotFoundError("e2e smoke: the train CLI left no best/ checkpoint")

    export = os.path.join(tmp, "export")
    secs["export"] = run_step("3/5 export", "export", "--run", os.path.join(runs, "smoke"), "--out-dir", export,
                              *dev)
    bundles = glob.glob(os.path.join(export, "*_bundle"))
    if len(bundles) != 1:
        raise FileNotFoundError(f"e2e smoke: export wrote {bundles}, not one bundle")
    bundle = bundles[0]
    _require(os.path.join(bundle, "params.msgpack"))
    _require(os.path.join(bundle, "meta.json"))
    if not glob.glob(os.path.join(export, "*_impulse.wav")):
        raise FileNotFoundError("e2e smoke: export wrote no impulse wav")

    out_wav = os.path.join(tmp, "transfer.wav")
    secs["transfer"] = run_step("4/5 transfer", "transfer", "--bundle", bundle, "--input",
                                os.path.join(tmp, "corpus", "validation", "tone0.wav"), "--output", out_wav, *dev)
    if os.path.getsize(_require(out_wav)) == 0:
        raise RuntimeError("e2e smoke: transfer.wav is empty")

    secs["performance"] = run_step("5/5 performance --bundle", "performance", "--bundle", bundle, "--n-run", "2",
                                   *dev)
    return secs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu, passed to every CLI")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no CLI is started for a device that is missing
    with tempfile.TemporaryDirectory(prefix="ddsp_e2e_") as tmp:
        print(f"== e2e smoke in {tmp}", flush=True)
        secs = journey(tmp, args.device)
    print("e2e smoke: all green " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()), flush=True)
    return secs


if __name__ == "__main__":
    main()
