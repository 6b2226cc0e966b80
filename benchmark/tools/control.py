"""The readings the limits of `correct` are set from, other than the
program's own: the control and the planted faults, at a cell's own size.

    python3 benchmark/tools/control.py --cell CELL --seeds 1,2,3 [--out FILE]

Reads, for a training cell, on the cell's inputs from each seed and judged
against the float64 reference exactly as the program is: the plain
reference put in the program's place with TF32 matrix products (one
precision below the configuration's float32 with TF32 off); the program's
own bf16 NN (model dtype bfloat16, eager steps), its lower-precision path
and the control the limits are held against; and the fault "half of the
batch left out, the loss the mean over the rest", planted in the reference
put in the program's place.  Prints one JSON line a seed.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.lib import judge  # noqa: E402
from benchmark.lib.corpus import loudness_stats, make_corpus  # noqa: E402
from benchmark.lib.weights import make_weights, sub_seed  # noqa: E402

COMPARED_STEPS = 3


@contextlib.contextmanager
def tf32(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def train_readings(cfg, params, seed, device) -> dict:
    tc, m = cfg["train"], cfg["model"]
    weights = make_weights(cfg, seed, device)
    corpus = make_corpus(cfg, int(params["corpus_items"]), seed, device)
    mean, std = loudness_stats(corpus)
    b, f, s = tc["batch"], cfg["preprocess"]["signal_length"] // m["block_size"], m["block_size"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    noises = [torch.rand((b, f, s), generator=gen, device=device) * 2.0 - 1.0
              for _ in range(COMPARED_STEPS)]
    data = {"sig": corpus.signals, "pitch": corpus.pitchs[..., None], "loudness": corpus.loudness[..., None]}
    if corpus.mfccs is not None:
        data["mfcc"] = corpus.mfccs[:, :-1]
    batches = [{k: torch.as_tensor(v[j * b:(j + 1) * b], device=device) for k, v in data.items()}
               for j in range(COMPARED_STEPS)]
    ref = judge.reference_train(cfg, weights, batches, noises, mean, std, torch.float64)
    out = {}
    with tf32(True):
        ctl = judge.reference_train(cfg, weights, batches, noises, mean, std, torch.float32)
    out["control_tf32"] = judge.train_numbers(ctl[0], ctl[1], ctl[2], ref, weights)
    out["program_bf16"] = _program_bf16(cfg, weights, batches, noises, mean, std, device, ref)
    half = b // 2
    hb = [{k: v[:half] for k, v in x.items()} for x in batches]
    flt = judge.reference_train(cfg, weights, hb, [n[:half] for n in noises], mean, std, torch.float64)
    out["fault_half_batch"] = judge.train_numbers(flt[0], flt[1], flt[2], ref, weights)
    return out


def _program_bf16(cfg, weights, batches, noises, mean, std, device, ref) -> dict:
    """The program's own bf16 NN (model dtype bfloat16), eager steps on the
    same inputs: the step below TF32 that a later change might take."""
    from ddsp_pytorch_tpu_torch.models import load_model
    from ddsp_pytorch_tpu_torch.training.optim import make_optimizer
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import make_train_step

    from benchmark.lib.weights import program_config

    m = cfg["model"]
    model = load_model(m["name"], {**{k: v for k, v in m.items() if k != "name"}, "dtype": "bfloat16"})
    model.load_state_dict(weights)
    model = model.to(device)
    pconf = program_config(cfg)
    tx = make_optimizer(pconf)
    state = TrainState(step=0, model=model, opt_state=tx.init(list(model.parameters())),
                       generator=torch.Generator(device=device), mean_loudness=mean, std_loudness=std)
    step = make_train_step(model, tx, pconf)
    names = [n for n, _ in model.named_parameters()]
    losses, g1 = [], None
    for batch, noise in zip(batches, noises):
        losses.append(float(step(state, batch, noise=noise)["loss"]))
        if g1 is None:
            g1 = {k: mu / 0.1 for k, mu in zip(names, state.opt_state["mu"])}
    p_end = {k: p.detach() for k, p in model.named_parameters()}
    return judge.train_numbers(losses, g1, p_end, ref, weights)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("control: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    spec = harness.benchmark_spec(ROOT)
    _, cfg, cell = harness.load_cell(spec, args.cell)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = train_readings(cfg, cell["params"], seed, device)
        line = json.dumps({"cell": args.cell, "seed": seed, **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
