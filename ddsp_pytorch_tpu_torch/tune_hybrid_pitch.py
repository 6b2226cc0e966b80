"""Tune the CREPE × YIN fusion weights of extract_pitch_hybrid on the
robustness conditions (port of scripts/tune_hybrid_pitch.py):

    python -m ddsp_pytorch_tpu_torch.tune_hybrid_pitch [--cache /tmp/hybrid_tune] \\
        [--n-validation 9] [--combos JSON] [--out FILE] [--device cuda]

The expensive evidence (CREPE salience and the YIN CMNDF on the 20-cent
grid, models/crepe.py `hybrid_evidence`) is computed once a file for every
fixtures.DEGRADATIONS condition and the two pitch-extreme conditions, and
cached as .npz with YIN's own track and the frame truth; then each
(yin_weight, switch_per_octave, salience_floor, confidence_gate) combination
runs only the fused Viterbi decode.  It reports RPA@50c per condition for
each combination beside YIN alone and raw CREPE, in the layout of
pretrained/hybrid_sweep_r05.json.  The device defaults to the GPU and there
is no fallback: --device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.data.fixtures import (
    DEGRADATIONS,
    cents_error,
    frame_truth,
    make_degrader,
    make_oof_corpus,
)
from ddsp_pytorch_tpu_torch.models.crepe import (
    cents_to_hz,
    decode_fused,
    hybrid_evidence,
    interp_to_block_grid,
    load_crepe,
    viterbi_cents,
)
from ddsp_pytorch_tpu_torch.ops.pitch import extract_pitch
from ddsp_pytorch_tpu_torch.utils.audio_io import load_wav


def conditions() -> list:
    """(tag, midi range, degrader kwargs) of every condition swept."""
    out = [(tag, (45, 76), kw) for tag, kw in DEGRADATIONS.items()]
    out += [("extremes_clean", (36, 86), {}),
            ("extremes_snr10_reverb", (36, 86), dict(snr_db=10.0, rt60=0.3))]
    return out


def build_cache(root: str, sample_rate: int, block_size: int, n_validation: int, model,
                conds=None, *, device="cuda") -> None:
    """Per condition, per validation file: the evidence, YIN's track and
    the frame truth → root/<condition>/<stem>.npz; a condition with a DONE
    marker is skipped."""
    device = resolve_device(device)
    for tag, midi_range, kw in conditions() if conds is None else conds:
        cond_dir = os.path.join(root, tag)
        done = os.path.join(cond_dir, "DONE")
        if os.path.exists(done):
            continue
        corpus = os.path.join(cond_dir, "corpus")
        make_oof_corpus(corpus, sample_rate=sample_rate, n_train=0, n_validation=n_validation,
                        midi_range=midi_range, seed=0, degrade_fn=make_degrader(**kw) if kw else None)
        with open(os.path.join(corpus, "truth", "meta.json")) as f:
            meta = json.load(f)
        for key in sorted(meta["files"]):
            part, stem = key.split("/")
            if part != "validation":
                continue
            sig, _ = load_wav(os.path.join(corpus, part, stem + ".wav"), sample_rate)
            truth = np.load(os.path.join(corpus, "truth", part, stem + ".npz"))
            sal, d16, hop = hybrid_evidence(sig, sample_rate, block_size, model, device=device)
            n_out = len(sig) // block_size
            yin_f0 = extract_pitch(sig, sample_rate, block_size, device=device).cpu().numpy()
            f0f, vf = frame_truth(truth["f0"], truth["voiced"], block_size, n_out)
            np.savez(os.path.join(cond_dir, stem + ".npz"), salience=sal.cpu().numpy(),
                     d16=d16.cpu().numpy(), hop=hop, n_out=n_out, yin_f0=yin_f0, f0f=f0f, vf=vf)
        with open(done, "w") as f:
            f.write("ok")
        print(f"[cache] {tag}", flush=True)


def rpa(est, f0f, vf) -> np.ndarray:
    """Per voiced frame: within 50 cents of the truth."""
    err = np.abs(cents_error(np.asarray(est)[vf], f0f[vf]))
    return err <= 50.0


def sweep(root: str, sample_rate: int, block_size: int, combos, *, device="cuda") -> dict:
    """{condition: {"yin", "crepe", <label>...: RPA@50c}} over the cached
    conditions, each combination's decode_fused kwargs run on `device`."""
    device = resolve_device(device)
    tags = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    table = {}
    for tag in tags:
        cond_dir = os.path.join(root, tag)
        hits = {"yin": [], "crepe": []}
        hits.update({label: [] for label, _ in combos})
        for f in sorted(f for f in os.listdir(cond_dir) if f.endswith(".npz")):
            z = np.load(os.path.join(cond_dir, f))
            sal = torch.tensor(z["salience"], device=device)
            d16 = torch.tensor(z["d16"], device=device)
            hop, n_out = int(z["hop"]), int(z["n_out"])
            f0f, vf = z["f0f"], z["vf"]
            hits["yin"].extend(rpa(z["yin_f0"], f0f, vf))
            crepe_f0 = interp_to_block_grid(cents_to_hz(viterbi_cents(sal)), hop, n_out, block_size,
                                            sample_rate)
            hits["crepe"].extend(rpa(crepe_f0.cpu().numpy(), f0f, vf))
            for label, kw in combos:
                est = interp_to_block_grid(decode_fused(sal, d16, **kw), hop, n_out, block_size, sample_rate)
                hits[label].extend(rpa(est.cpu().numpy(), f0f, vf))
        table[tag] = {k: float(np.mean(v)) for k, v in hits.items()}
        row = "  ".join(f"{k}={v:.3f}" for k, v in table[tag].items())
        print(f"[{tag}] {row}", flush=True)
    return table


def default_combos() -> list:
    """The default grid; it holds the shipped extract_pitch_hybrid defaults
    (yin_weight 8, switch_per_octave 60, floor 0.03, gate 2)."""
    return [
        (f"y{w}_s{sw}_f{fl}_g{g}",
         dict(yin_weight=w, switch_per_octave=sw, salience_floor=fl, confidence_gate=g))
        for w in (4.0, 8.0, 16.0)
        for sw in (10.0, 60.0, 100.0)
        for fl in (1e-6, 0.03)
        for g in (0.0, 2.0)
    ]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cache", default="/tmp/hybrid_tune")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--block-size", type=int, default=256)
    p.add_argument("--n-validation", type=int, default=9)
    p.add_argument("--crepe", default="pretrained/crepe_tiny.msgpack")
    p.add_argument("--capacity", default="tiny")
    p.add_argument("--combos", default=None, help="JSON list of [label, decode_fused kwargs] pairs")
    p.add_argument("--out", default="/tmp/hybrid_tune/sweep.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    model = load_crepe(args.crepe, args.capacity, device=device)
    os.makedirs(args.cache, exist_ok=True)
    build_cache(args.cache, args.sample_rate, args.block_size, args.n_validation, model, device=device)
    combos = ([(label, kw) for label, kw in json.loads(args.combos)] if args.combos
              else default_combos())
    table = sweep(args.cache, args.sample_rate, args.block_size, combos, device=device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
    print(f"wrote {args.out}")
    return table


if __name__ == "__main__":
    main()
