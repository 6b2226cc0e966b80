"""Weights from the seed, made on the device in two large draws, and the
bundle the served cells hand to the server.

The names are the flax-style tree both the program's state_dict and the
plain reference use.  Dense and GRU matrices are N(0, 1/fan_in); biases,
LayerNorm offsets and scales (around 1) are N(0, 0.1²) so that every term
of the arithmetic is exercised; the reverb's noise is U(−1, 1), its decay
and wet gain their initial values (5 and 0).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

N_MLP_LAYERS = 3
N_MFCC = 30
Z_DIM = 16


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for stream `stream` of run seed `seed`."""
    return int(np.random.SeedSequence([int(seed) % 2**64, stream]).generate_state(1, np.uint64)[0] >> 1)


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of the configuration's model;
    kind is "matrix", "offset", "scale", "reverb_noise", "decay" or "wet"."""
    m = cfg["model"]
    h, k, nb = m["hidden_size"], m["n_harmonic"], m["n_bands"]
    ae = m["name"] == "mfcc-autoencoder"
    spec = []

    def mlp(prefix, fan_in):
        for i in range(N_MLP_LAYERS):
            spec.append((f"{prefix}.Dense_{i}.weight", (h, fan_in if i == 0 else h), "matrix"))
            spec.append((f"{prefix}.Dense_{i}.bias", (h,), "offset"))
            spec.append((f"{prefix}.LayerNorm_{i}.weight", (h,), "scale"))
            spec.append((f"{prefix}.LayerNorm_{i}.bias", (h,), "offset"))

    def gru(prefix, fan_in):
        spec.append((f"{prefix}.weight_ih", (3 * h, fan_in), "matrix"))
        spec.append((f"{prefix}.weight_hh", (3 * h, h), "matrix"))
        spec.append((f"{prefix}.bias_ih", (3 * h,), "offset"))
        spec.append((f"{prefix}.bias_hh", (3 * h,), "offset"))

    if ae:
        spec.append(("encoder.LayerNorm_0.weight", (N_MFCC,), "scale"))
        spec.append(("encoder.LayerNorm_0.bias", (N_MFCC,), "offset"))
        gru("encoder.GRU_0", N_MFCC)
        spec.append(("encoder.Dense_0.weight", (Z_DIM, h), "matrix"))
        spec.append(("encoder.Dense_0.bias", (Z_DIM,), "offset"))
    mlp("decoder.f0_mlp", 1)
    mlp("decoder.loudness_mlp", 1)
    if ae:
        mlp("decoder.z_mlp", Z_DIM)
    gru("decoder.gru", (3 if ae else 2) * h)
    mlp("decoder.out_mlp", h + 2)
    spec.append(("harmonic_proj.weight", (k + 1, h), "matrix"))
    spec.append(("harmonic_proj.bias", (k + 1,), "offset"))
    spec.append(("noise_proj.weight", (nb, h), "matrix"))
    spec.append(("noise_proj.bias", (nb,), "offset"))
    if m["has_reverb"]:
        spec.append(("reverb.noise", (m["sample_rate"],), "reverb_noise"))
        spec.append(("reverb.decay", (), "decay"))
        spec.append(("reverb.wet", (), "wet"))
    return spec


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights on `device` from `seed`: one normal draw for every
    matrix, bias and LayerNorm leaf, one uniform draw for the reverb."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    sizes = [int(np.prod(s)) for _, s, kind in spec if kind in ("matrix", "offset", "scale")]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    n_rev = sum(int(np.prod(s)) for _, s, kind in spec if kind == "reverb_noise")
    uniform = torch.rand(n_rev, generator=gen, device=device) * 2.0 - 1.0
    out, at, at_u = {}, 0, 0
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        if kind in ("matrix", "offset", "scale"):
            x = normal[at:at + n].reshape(shape)
            at += n
            if kind == "matrix":
                x = x / float(np.sqrt(shape[1]))
            elif kind == "offset":
                x = 0.1 * x
            else:
                x = 1.0 + 0.1 * x
        elif kind == "reverb_noise":
            x = uniform[at_u:at_u + n].reshape(shape)
            at_u += n
        elif kind == "decay":
            x = torch.full(shape, 5.0, device=device)
        else:
            x = torch.zeros(shape, device=device)
        out[name] = x.contiguous()
    return out


def program_config(cfg: dict, steps_per_call: int = 1):
    """The program's Config object for this configuration."""
    from ddsp_pytorch_tpu_torch.config import Config

    kwargs = {k: v for k, v in cfg["model"].items() if k != "name"}
    return Config.from_dict({
        "preprocess": dict(cfg["preprocess"]),
        "model": {"name": cfg["model"]["name"], "kwargs": kwargs},
        "train": {**cfg["train"], "steps_per_call": steps_per_call,
                  "scan_unroll": cfg["assumed"]["scan_unroll"]},
    })


def write_bundle(cfg: dict, weights: Dict[str, torch.Tensor], mean_loudness: float,
                 std_loudness: float, bundle_dir: str) -> str:
    """Write the weights as the program's exporter lays out a bundle
    (params.msgpack, config.yaml, meta.json) and return its directory."""
    from ddsp_pytorch_tpu_torch.bundle import write_params
    from ddsp_pytorch_tpu_torch.export import BUNDLE_FORMAT
    from ddsp_pytorch_tpu_torch.weights import state_dict_to_flax

    os.makedirs(bundle_dir, exist_ok=True)
    config = program_config(cfg)
    config.data.mean_loudness = float(mean_loudness)
    config.data.std_loudness = float(std_loudness)
    write_params(bundle_dir, state_dict_to_flax({k: v.cpu() for k, v in weights.items()}))
    config.to_yaml(os.path.join(bundle_dir, "config.yaml"))
    meta = {
        "format": BUNDLE_FORMAT,
        "model": {"name": config.model.name, "kwargs": config.model.kwargs},
        "mean_loudness": float(mean_loudness),
        "std_loudness": float(std_loudness),
        "sample_rate": config.preprocess.sample_rate,
        "block_size": config.preprocess.block_size,
    }
    with open(os.path.join(bundle_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return bundle_dir
