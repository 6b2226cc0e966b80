"""RAVE v1's weights and BatchNorm statistics from the seed, made on the
device in one draw, independent of the program's initialiser.

The names are the program's state_dict names, which the plain reference
takes too (benchmark/reference/rave.py).  Convolution kernels are N(0,
1/fan_in), fan_in the inputs one output sums (C_in/groups · width; C_in ·
width / stride for a transposed one); a weight-normalised kernel's g is
‖v‖ of its slice times 1 + 0.1·N, so the norm's scale is not 1; biases,
BatchNorm offsets and running means N(0, 0.1²); BatchNorm scales and
running variances 1 + 0.1·N; the batch counters 0.  So every term of the
step is exercised: a scale that is not 1, an offset that is not 0, and a
running update whose old value is neither 0 nor 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.lib.weights import sub_seed


def param_spec(model: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, fan_in) of every parameter and statistic; kind
    is "matrix", "wn_v", "wn_g", "offset", "scale" or "count"."""
    m, c, lat, ratios = model["n_band"], model["capacity"], model["latent_size"], model["ratios"]
    spec = []

    def conv(name, c_in, c_out, k, groups=1):
        spec.extend([(f"{name}.weight", (c_out, c_in // groups, k), "matrix", c_in // groups * k),
                     (f"{name}.bias", (c_out,), "offset", 0)])

    def wn(name, c_in, c_out, k, stride=1, transposed=False):
        shape = (c_in, c_out, k) if transposed else (c_out, c_in, k)
        spec.extend([(f"{name}.weight_v", shape, "wn_v", c_in * k / stride),
                     (f"{name}.weight_g", (shape[0], 1, 1), "wn_g", 0), (f"{name}.bias", (c_out,), "offset", 0)])

    dims = [c * 2**i for i in range(len(ratios) + 1)]
    conv("encoder.conv_in", m, c, 7)
    for i, (d, r) in enumerate(zip(dims, ratios)):
        spec.extend([(f"encoder.norms.{i}.weight", (d,), "scale", 0), (f"encoder.norms.{i}.bias", (d,), "offset", 0),
                     (f"encoder.norms.{i}.running_mean", (d,), "offset", 0),
                     (f"encoder.norms.{i}.running_var", (d,), "scale", 0),
                     (f"encoder.norms.{i}.num_batches_tracked", (), "count", 0)])
        conv(f"encoder.convs.{i}", d, dims[i + 1], 2 * r + 1)
    conv("encoder.conv_out", dims[-1], 2 * lat, 5, groups=2)
    dims = dims[::-1]
    wn("decoder.conv_in", lat, dims[0], 7)
    for i, r in enumerate(ratios):
        wn(f"decoder.ups.{i}", dims[i], dims[i + 1], 2 * r, stride=r, transposed=True)
        for j in range(3):
            wn(f"decoder.stacks.{i}.{j}.conv1", dims[i + 1], dims[i + 1], 3)
            wn(f"decoder.stacks.{i}.{j}.conv2", dims[i + 1], dims[i + 1], 3)
    wn("decoder.wave", c, m, 7)
    wn("decoder.loud", c, 1, 2 * model["loud_stride"] + 1)
    chans = [c] * len(model["noise_ratios"]) + [m * model["noise_bands"]]
    for i in range(len(model["noise_ratios"])):
        conv(f"decoder.noise.convs.{i}", chans[i], chans[i + 1], 3)
    return spec


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights and statistics on `device` from run seed `seed`
    (stream 1, as the other cells' weights)."""
    spec = param_spec(cfg["model"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    normal = torch.randn(sum(int(np.prod(s)) for _, s, _, _ in spec), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in spec:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = int(np.prod(shape))
        x = normal[at:at + n].reshape(shape)
        at += n
        if kind in ("matrix", "wn_v"):
            x = x / float(np.sqrt(fan_in))
        elif kind == "wn_g":
            v = out[name[:-len("_g")] + "_v"]
            x = torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True) * (1.0 + 0.1 * x)
        elif kind == "offset":
            x = 0.1 * x
        else:
            x = 1.0 + 0.1 * x
        out[name] = x.contiguous()
    return out
