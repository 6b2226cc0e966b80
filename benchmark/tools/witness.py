"""Second witnesses for a training cell's first step: how far each of
several computations of the same step lies from the float64 reference.

    python3 benchmark/tools/witness.py --cell decoder.train_b16 --seeds 1,2 [--cpu]

On the cell's inputs from each seed (weights, the loader's first batch,
the state generator's first noise) it reads, against the reference in
float64 on the card: the program's eager step in float32 on the card; the
reference in float32 (TF32 off) and with TF32 products (the control); and
with --cpu the program's step on the CPU in float64 and in float32 (its
plain paths, no kernels).  For each: the loss gap, the worst leaves of the
first gradient, and the median leaf's gap.  One JSON line a computation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.lib import judge  # noqa: E402
from benchmark.lib.corpus import loudness_stats, make_corpus  # noqa: E402
from benchmark.lib.weights import make_weights, sub_seed  # noqa: E402
from benchmark.tools.control import tf32  # noqa: E402


def _line(label, seed, loss, grads, ref_loss, ref_g):
    names = list(ref_g)
    gaps = judge.leaf_gaps(grads, ref_g, names)
    norm = lambda g: float(sum(judge._norm(g[k]) ** 2 for k in names)) ** 0.5  # noqa: E731
    return {"what": label, "seed": seed, "loss_gap": abs(loss - ref_loss) / abs(ref_loss),
            "grad_gap": max(gaps.values()), "median_leaf_gap": float(np.median(list(gaps.values()))),
            "global_grad_gap": abs(norm(grads) - norm(ref_g)) / norm(ref_g),
            "worst": judge.worst(gaps, 5)}


def main() -> None:
    from ddsp_pytorch_tpu_torch.data.dataset import DataLoader
    from ddsp_pytorch_tpu_torch.models import load_model
    from ddsp_pytorch_tpu_torch.training.train import loss_and_grads

    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    spec = harness.benchmark_spec(ROOT)
    _, cfg, cell = harness.load_cell(spec, args.cell)
    m, tc = cfg["model"], cfg["train"]
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        weights = make_weights(cfg, seed, dev)
        corpus = make_corpus(cfg, int(cell["params"]["corpus_items"]), seed, dev)
        mean, std = loudness_stats(corpus)
        loader = DataLoader(corpus, tc["batch"], shuffle=True, drop_last=True, seed=sub_seed(seed, 3) % 2**32)
        idx = next(loader.index_batches())
        data = {"sig": corpus.signals, "pitch": corpus.pitchs[..., None], "loudness": corpus.loudness[..., None]}
        if corpus.mfccs is not None:
            data["mfcc"] = corpus.mfccs[:, :-1]
        batch = {k: torch.as_tensor(v[idx], device=dev) for k, v in data.items()}
        gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 4))
        noise = torch.rand((tc["batch"], batch["pitch"].shape[1], m["block_size"]), generator=gen, device=dev) * 2 - 1
        ref = judge.reference_train(cfg, weights, [batch], [noise], mean, std, torch.float64)
        r_loss, r_g = ref[0][0], ref[1]
        out = []
        for label, dtype, on in (("reference float32", torch.float32, False),
                                 ("reference TF32 (control)", torch.float32, True)):
            with tf32(on):
                r = judge.reference_train(cfg, weights, [batch], [noise], mean, std, dtype)
            out.append(_line(label, seed, r[0][0], r[1], r_loss, r_g))

        def program(device, dtype):
            model = load_model(m["name"], {k: v for k, v in m.items() if k != "name"})
            model.load_state_dict({k: v.cpu() for k, v in weights.items()})
            model = model.to(device=device, dtype=dtype)
            b = {k: v.to(device=device, dtype=dtype) for k, v in batch.items()}
            loss, grads = loss_and_grads(model, b, mean, std, tc["scales"], tc["overlap"],
                                         noise=noise.to(device=device, dtype=dtype))
            names = [n for n, _ in model.named_parameters()]
            return float(loss), dict(zip(names, (g.detach() for g in grads)))

        out.append(_line("program float32, card", seed, *program(dev, torch.float32), r_loss, r_g))
        if args.cpu:
            out.append(_line("program float64, CPU", seed, *program(torch.device("cpu"), torch.float64), r_loss, r_g))
            out.append(_line("program float32, CPU", seed, *program(torch.device("cpu"), torch.float32), r_loss, r_g))
        for line in out:
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
