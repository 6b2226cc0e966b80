"""CREPE's weights and BatchNorm statistics from the seed, made on the
device in one draw, independent of the program's initialiser.

The names are the program's state_dict names, which the plain reference
takes too: conv1..conv6 and classifier (`.weight`, `.bias`; kernels (out,
in, width), the classifier (360, in)) and bn1..bn6 (`.weight`, `.bias`,
`.running_mean`, `.running_var`).  Kernels are N(0, 1/fan_in); biases,
BatchNorm offsets and running means N(0, 0.1²); BatchNorm scales and
running variances 1 + 0.1·N.  So every term of the step is exercised: a
scale that is not 1, an offset that is not 0, and a running update whose
old value is neither 0 nor 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.lib.weights import sub_seed
from benchmark.reference.crepe import N_BINS, block_shapes


def param_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and statistic, in the
    program's state_dict order; kind is "matrix", "offset" or "scale"."""
    spec, channels = [], 1
    for i, (c, w) in enumerate(zip(model["filters"], model["widths"])):
        n = i + 1
        spec += [(f"conv{n}.weight", (c, channels, w), "matrix"), (f"conv{n}.bias", (c,), "offset"),
                 (f"bn{n}.weight", (c,), "scale"), (f"bn{n}.bias", (c,), "offset"),
                 (f"bn{n}.running_mean", (c,), "offset"), (f"bn{n}.running_var", (c,), "scale")]
        channels = c
    _, c, t = block_shapes(model, 1)[-1]
    spec += [("classifier.weight", (N_BINS, c * t), "matrix"), ("classifier.bias", (N_BINS,), "offset")]
    return spec


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights and statistics on `device` from run seed `seed`
    (stream 1, as the DDSP cells' weights)."""
    spec = param_spec(cfg["model"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    normal = torch.randn(sum(int(np.prod(s)) for _, s, _ in spec), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        x = normal[at:at + n].reshape(shape)
        at += n
        if kind == "matrix":
            x = x / float(np.sqrt(np.prod(shape[1:])))
        elif kind == "offset":
            x = 0.1 * x
        else:
            x = 1.0 + 0.1 * x
        out[name] = x.contiguous()
    return out
