"""Trained run → bundle, and bundle → model → StreamingSynth.

Port of ddsp_pytorch_tpu/export/__init__.py:35-210 (`export_run`,
`_render_impulse`, `load_bundle`, `make_streaming_synth`,
`make_stream_session`, `make_streaming_mfcc`) and of the repository's
export.py CLI:

    python -m ddsp_pytorch_tpu_torch.export --run runs/NAME [--out-dir export] \\
        [--name NAME] [--data] [--set key.path=value ...] [--device cuda]

`export_run` writes what the JAX package writes, in the same formats, so
the port's server, the JAX package's `load_bundle` and its C++ runtime all
serve a bundle the port exported:

  ddsp_<name>_bundle/params.msgpack   the parameters (flax msgpack)
  ddsp_<name>_bundle/config.yaml      frozen config incl. loudness stats
  ddsp_<name>_bundle/meta.json        model name/kwargs + stats + format tag
  ddsp_<name>_impulse.wav             the trained reverb impulse, 16-bit PCM
  ddsp_<name>_config.yaml             frozen config copy next to the bundle

A bundle is read through bundle.py: meta.json for the model and the
loudness stats, params.msgpack for the weights, and config.yaml for the
autoencoder's MFCC geometry.  Both model families export, load and
stream.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.bundle import read_meta, read_params, write_params
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import load_model
from ddsp_pytorch_tpu_torch.streaming import AutoencoderStreamSession, StreamingSynth, StreamingMFCC
from ddsp_pytorch_tpu_torch.training.state import Checkpointer
from ddsp_pytorch_tpu_torch.utils import save_wav
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict, state_dict_to_flax

BUNDLE_FORMAT = "ddsp_pytorch_tpu.bundle.v1"
# export/__init__.py:66-81: the autoencoder's training MFCCs and the live
# extractor agree only with a fixed dB reference
MFCC_REF_DB_WARNING = (
    "exporting an mfcc-autoencoder trained with preprocess.mfcc_ref_db=None: training MFCCs "
    "used librosa's anti-causal global-max dB floor, but the live StreamingMFCC is causal and "
    "floorless, so streamed features will diverge from training features on quiet mel bins. "
    "Retrain with a fixed mfcc_ref_db (configs/autoencoder.yaml sets 0.0) for exact "
    "train==stream agreement."
)


def load_bundle(bundle_dir: str, device="cuda") -> Tuple:
    """Load an exported bundle → (model on `device`, in eval mode, meta)."""
    device = resolve_device(device)
    meta = read_meta(bundle_dir)
    model = load_model(meta["model"]["name"], meta["model"]["kwargs"])
    model.load_state_dict(flax_to_state_dict(read_params(bundle_dir)), strict=True)
    return model.to(device).eval(), meta


def make_streaming_synth(bundle_dir: str, batch: int = 1, device="cuda", **kwargs):
    """Bundle → ready StreamingSynth on `device` (kwargs: seed,
    noise_deterministic, include_reverb)."""
    model, meta = load_bundle(bundle_dir, device=device)
    mean = meta.get("mean_loudness")
    std = meta.get("std_loudness")
    return StreamingSynth(
        model,
        mean_loudness=0.0 if mean is None else mean,
        std_loudness=1.0 if std is None else std,
        batch=batch,
        device=device,
        **kwargs,
    )


def make_stream_session(bundle_dir: str, seed: int = 0, device="cuda", **kwargs):
    """Bundle → a sample-rate streaming session for either model family
    (export/__init__.py:160-177).

    A decoder bundle gives the StreamingSynth itself (needs_audio False,
    `step_samples(pitch, loudness)`); an mfcc-autoencoder bundle gives an
    AutoencoderStreamSession (needs_audio True, `step_samples(pitch,
    loudness, audio)`, one block of output latency).  This is the one
    constructor a host program loads."""
    synth = make_streaming_synth(bundle_dir, seed=seed, device=device, **kwargs)
    if not synth.autoencoder:
        return synth
    return AutoencoderStreamSession(synth, make_streaming_mfcc(bundle_dir), seed=seed)


def make_streaming_mfcc(bundle_dir: str) -> StreamingMFCC:
    """Bundle → the causal batch-1 StreamingMFCC of its preprocess geometry
    (export/__init__.py:180-210), the live feature extractor of an
    autoencoder stream.

    Streamed and training features agree exactly only where the bundle was
    preprocessed with a fixed preprocess.mfcc_ref_db; with None the
    training features used the anti-causal global-maximum floor and the
    live extractor runs without a floor."""
    pc = Config.from_yaml(os.path.join(bundle_dir, "config.yaml")).preprocess
    return StreamingMFCC(
        pc.sample_rate,
        n_mfcc=pc.n_mfcc,
        n_fft=pc.mfcc_n_fft,
        hop_length=pc.block_size,
        fmin=pc.mfcc_fmin,
        fmax=pc.mfcc_fmax,
        n_mels=pc.n_mels,
        ref_db=pc.mfcc_ref_db,
    )


def _render_impulse(model) -> Optional[np.ndarray]:
    """The trained reverb's impulse response (float32), if the model has a
    reverb (export/__init__.py:35-43)."""
    reverb = getattr(model, "reverb", None)
    if reverb is None:
        return None
    with torch.no_grad():
        return reverb.build_impulse().cpu().numpy().astype(np.float32)


def run_params(run_dir: str) -> dict:
    """The run's best-loss params if it saved some, else the newest full
    checkpoint's (export/__init__.py:90-104), as a CPU state_dict."""
    ckpt = Checkpointer(run_dir)
    if ckpt.best_meta() is not None:
        return torch.load(os.path.join(ckpt.best_dir, "params.pt"), map_location="cpu",
                          weights_only=True)
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {run_dir}")
    saved = torch.load(os.path.join(ckpt.ckpt_dir, f"{step}.pt"), map_location="cpu",
                       weights_only=True)
    return saved["params"]


def export_run(
    run_dir: str,
    out_dir: str = "export",
    name: Optional[str] = None,
    overrides: Optional[list] = None,
    device="cuda",
) -> str:
    """Export a training run of the port; returns the bundle directory.

    `overrides`: ``key.path=value`` strings applied to the run's frozen
    config first (Config.apply_overrides), e.g. to relocate
    ``data.data_location``; fields that shaped the parameters must not
    change.  The impulse is rendered on `device`.  An mfcc-autoencoder
    trained with preprocess.mfcc_ref_db None exports with a warning, as in
    the JAX package: its stream's features differ from its training's."""
    device = resolve_device(device)
    run_dir = os.path.normpath(run_dir)
    name = name or os.path.basename(run_dir)
    os.makedirs(out_dir, exist_ok=True)
    config = Config.from_yaml(os.path.join(run_dir, "config.yaml"))
    if overrides:
        config.apply_overrides(overrides)
    if config.model.name == "mfcc-autoencoder" and config.preprocess.mfcc_ref_db is None:
        warnings.warn(MFCC_REF_DB_WARNING, stacklevel=2)
    model = load_model(config.model.name, config.model.kwargs)
    model.load_state_dict(run_params(run_dir), strict=True)
    model = model.to(device)

    bundle_dir = os.path.join(out_dir, f"ddsp_{name}_bundle")
    os.makedirs(bundle_dir, exist_ok=True)
    write_params(bundle_dir, state_dict_to_flax(model.state_dict()))
    config.to_yaml(os.path.join(bundle_dir, "config.yaml"))
    config.to_yaml(os.path.join(out_dir, f"ddsp_{name}_config.yaml"))
    meta = {
        "format": BUNDLE_FORMAT,
        "model": {"name": config.model.name, "kwargs": config.model.kwargs},
        "mean_loudness": config.data.mean_loudness,
        "std_loudness": config.data.std_loudness,
        "sample_rate": config.preprocess.sample_rate,
        "block_size": config.preprocess.block_size,
    }
    with open(os.path.join(bundle_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    impulse = _render_impulse(model)
    if impulse is not None:
        save_wav(os.path.join(out_dir, f"ddsp_{name}_impulse.wav"), impulse,
                 config.preprocess.sample_rate)
    return bundle_dir


def copy_data(bundle_dir: str, out_dir: str) -> int:
    """Copy the run's training audio (data.data_location, every
    *.<data.extension> below it, the tree kept) to <out_dir>/data, as the
    repository's export.py --data does.  Returns the number of files."""
    config = Config.from_yaml(os.path.join(bundle_dir, "config.yaml"))
    root = Path(config.data.data_location).resolve()
    files = sorted(root.rglob(f"*.{config.data.extension}"))
    for f in files:
        dst = Path(out_dir) / "data" / f.relative_to(root)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, dst)
    return len(files)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Export a training run of the port as a bundle.")
    p.add_argument("--run", required=True)
    p.add_argument("--out-dir", default="export")
    p.add_argument("--name", default=None)
    p.add_argument("--data", action="store_true",
                   help="also copy the training wavs next to the bundle")
    p.add_argument("--set", action="append", default=[], dest="overrides", metavar="KEY.PATH=VALUE",
                   help="override any field of the run's frozen config before export "
                        "(dotted path, YAML scalar value; repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    bundle = export_run(args.run, args.out_dir, name=args.name, overrides=args.overrides,
                        device=args.device)
    print(f"exported bundle: {bundle}")
    if args.data:
        n = copy_data(bundle, args.out_dir)
        print(f"copied {n} wavs to {os.path.join(args.out_dir, 'data')}")
    return bundle


if __name__ == "__main__":
    main()
