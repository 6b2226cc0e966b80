"""Raw pitch accuracy (RPA, cents) of the pitch trackers on the
out-of-family corpus (port of scripts/pitch_accuracy.py):

    python -m ddsp_pytorch_tpu_torch.pitch_accuracy [--corpus DIR] [--out FILE] \\
        [--crepe pretrained/crepe_tiny.msgpack] [--degraded] [--pitch-range FMIN FMAX] \\
        [--device cuda]

For every validation file of a fixtures corpus (data/fixtures.py: plucks,
FM brass and bowed saws with their exact f0) it runs YIN with Viterbi
(ops/pitch.py), the CREPE network and the CREPE × YIN fusion
(models/crepe.py) on `--device`, and reports RPA@50c and the mean and
median |cents| by family and overall, in the JSON layout of
pretrained/pitch_accuracy.json.  Without --corpus a 16 kHz corpus is made
in a temporary directory.  --degraded scores the same notes under every
fixtures.DEGRADATIONS condition and at the pitch extremes, in the layout
of pretrained/pitch_robustness.json.  The device defaults to the GPU and
there is no fallback: --device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.data.fixtures import (
    DEGRADATIONS,
    cents_error,
    frame_truth,
    make_degrader,
    make_oof_corpus,
    summarize_cents,
)
from ddsp_pytorch_tpu_torch.models.crepe import extract_pitch_crepe, extract_pitch_hybrid, load_crepe
from ddsp_pytorch_tpu_torch.ops.pitch import extract_pitch
from ddsp_pytorch_tpu_torch.utils.audio_io import load_wav


def make_trackers(sr: int, block_size: int, crepe_bundle=None, crepe_capacity: str = "tiny",
                  pitch_range=None, *, device="cuda") -> dict:
    """{name: signal (T,) → f0 (F,) numpy} on `device`: "yin", and with a
    CREPE bundle "crepe" and "hybrid".  pitch_range=(fmin, fmax) restricts
    the CREPE trackers as make_pitch_fn does; None keeps their defaults."""
    device = resolve_device(device)
    trackers = {"yin": lambda sig: extract_pitch(sig, sr, block_size, device=device).cpu().numpy()}
    if crepe_bundle is not None:
        model = load_crepe(crepe_bundle, crepe_capacity, device=device)
        limits = dict(zip(("fmin", "fmax"), pitch_range)) if pitch_range else {}
        trackers["crepe"] = lambda sig: extract_pitch_crepe(
            sig, sr, block_size, model, device=device, **limits).cpu().numpy()
        trackers["hybrid"] = lambda sig: extract_pitch_hybrid(
            sig, sr, block_size, model, device=device, **limits).cpu().numpy()
    return trackers


def score_corpus(corpus: str, block_size: int, crepe_bundle=None, crepe_capacity: str = "tiny",
                 partition: str = "validation", pitch_range=None, *, device="cuda") -> dict:
    """RPA of each tracker on one partition of a fixtures corpus
    (pitch_accuracy.py:38-123): per file, by family and overall."""
    with open(os.path.join(corpus, "truth", "meta.json")) as f:
        meta = json.load(f)
    sr = meta["sample_rate"]
    trackers = make_trackers(sr, block_size, crepe_bundle, crepe_capacity, pitch_range, device=device)

    per_file = []
    acc = {t: {} for t in trackers}
    for key, info in sorted(meta["files"].items()):
        part, stem = key.split("/")
        if part != partition:
            continue
        sig, _ = load_wav(os.path.join(corpus, part, stem + ".wav"), sr)
        truth = np.load(os.path.join(corpus, "truth", part, stem + ".npz"))
        for name, fn in trackers.items():
            est = fn(sig)
            f0f, vf = frame_truth(truth["f0"], truth["voiced"], block_size, len(est))
            err = np.abs(cents_error(est[vf], f0f[vf]))
            per_file.append({"file": key, "tracker": name, "family": info["family"],
                             **summarize_cents(err)})
            acc[name].setdefault(info["family"], []).extend(err.tolist())

    summary = {}
    for name, fams in acc.items():
        all_err = []
        summary[name] = {"families": {}}
        for fam, errs in sorted(fams.items()):
            summary[name]["families"][fam] = summarize_cents(errs)
            all_err.extend(errs)
        summary[name]["overall"] = summarize_cents(all_err)
    return {"block_size": block_size, "sample_rate": sr, "partition": partition,
            "summary": summary, "per_file": per_file}


def _fmt(x, spec: str = ".1f") -> str:
    """A summarize_cents value; None (no frames) → 'n/a'."""
    return "n/a" if x is None else format(x, spec)


def robustness_report(sample_rate: int, block_size: int, crepe_bundle, crepe_capacity: str,
                      n_validation: int = 9, pitch_range=None, *, device="cuda") -> dict:
    """RPA under every fixtures.DEGRADATIONS condition (midi 45-76) and at
    the pitch extremes (midi 36-86, clean and at 10 dB SNR with reverb),
    the truth always the clean f0 (pitch_accuracy.py:132-180)."""
    device = resolve_device(device)
    out = {"sample_rate": sample_rate, "block_size": block_size, "n_validation": n_validation,
           "conditions": {}, "extremes": {}}
    with tempfile.TemporaryDirectory(prefix="ddsp_pitch_robust_") as root:

        def run(tag, midi_range, cond_kwargs, bucket):
            corpus = os.path.join(root, bucket + "_" + tag)
            degrade = make_degrader(**cond_kwargs) if cond_kwargs else None
            make_oof_corpus(corpus, sample_rate=sample_rate, n_train=0, n_validation=n_validation,
                            midi_range=midi_range, seed=0, degrade_fn=degrade)
            rep = score_corpus(corpus, block_size, crepe_bundle=crepe_bundle,
                               crepe_capacity=crepe_capacity, pitch_range=pitch_range, device=device)
            out[bucket][tag] = dict(rep["summary"])
            for name, s in rep["summary"].items():
                o = s["overall"]
                print(f"  [{bucket}/{tag}] {name}: RPA@50c={o['rpa']:.3f} "
                      f"mean|cents|={_fmt(o['mean_abs_cents'])} n={o['n_frames']}")

        for tag, kwargs in DEGRADATIONS.items():
            run(tag, (45, 76), kwargs, "conditions")
        run("clean", (36, 86), {}, "extremes")
        run("snr10_reverb", (36, 86), dict(snr_db=10.0, rt60=0.3), "extremes")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--corpus", default=None, help="an existing fixtures corpus (default: make one)")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--block-size", type=int, default=256)
    p.add_argument("--crepe", default="pretrained/crepe_tiny.msgpack")
    p.add_argument("--crepe-capacity", default="tiny")
    p.add_argument("--out", default=None,
                   help="output JSON (default pretrained/pitch_accuracy.json, or "
                        "pretrained/pitch_robustness.json with --degraded)")
    p.add_argument("--degraded", action="store_true",
                   help="RPA under every fixtures.DEGRADATIONS condition and at the pitch extremes")
    p.add_argument("--n-validation", type=int, default=9)
    p.add_argument("--pitch-range", type=float, nargs=2, default=None, metavar=("FMIN", "FMAX"),
                   help="restrict the CREPE trackers to [FMIN, FMAX] Hz as make_pitch_fn does")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    crepe = args.crepe if args.crepe and os.path.exists(args.crepe) else None
    if args.degraded:
        out_path = args.out or "pretrained/pitch_robustness.json"
        report = robustness_report(args.sample_rate, args.block_size, crepe, args.crepe_capacity,
                                   args.n_validation, pitch_range=args.pitch_range, device=device)
        if args.pitch_range:
            report["pitch_range"] = list(args.pitch_range)
    else:
        out_path = args.out or "pretrained/pitch_accuracy.json"
        with tempfile.TemporaryDirectory(prefix="ddsp_pitch_accuracy_") as tmp:
            corpus = args.corpus
            if corpus is None:
                corpus = os.path.join(tmp, "oof")
                make_oof_corpus(corpus, sample_rate=args.sample_rate, n_train=0,
                                n_validation=args.n_validation)
                print(f"generated corpus at {corpus}")
            report = score_corpus(corpus, args.block_size, crepe_bundle=crepe,
                                  crepe_capacity=args.crepe_capacity, pitch_range=args.pitch_range,
                                  device=device)
        for name, s in report["summary"].items():
            o = s["overall"]
            print(f"{name}: RPA@50c={o['rpa']:.3f} mean|cents|={_fmt(o['mean_abs_cents'])} "
                  f"median={_fmt(o['median_abs_cents'])} n={o['n_frames']}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out_path}")
    return report


if __name__ == "__main__":
    main()
