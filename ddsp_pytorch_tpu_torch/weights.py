"""flax parameter tree ⇄ this package's state_dict.

The port's modules keep flax's module names (`decoder.f0_mlp.Dense_0`,
`decoder.gru`, `harmonic_proj`, ...), so a state_dict key is the flax path
with its leaf renamed to PyTorch's convention.  The layout differences
(the same mapping as ddsp_pytorch_tpu/utils/torch_reference.py:31-64):

  Dense      kernel (in, out)        → weight (out, in)      transposed
  LayerNorm  scale, bias             → weight, bias
  GRU        w_ih (in, 3H), w_hh (H, 3H), gate order [r, z, n]
                                     → weight_ih (3H, in), weight_hh (3H, H)
             b_ih, b_hh              → bias_ih, bias_hh
  Reverb     noise, decay, wet       → unchanged
"""

from __future__ import annotations

import numpy as np
import torch

# leaf name → (state_dict leaf name, transpose)
_LEAF = {
    "kernel": ("weight", True),
    "scale": ("weight", False),
    "bias": ("bias", False),
    "w_ih": ("weight_ih", True),
    "w_hh": ("weight_hh", True),
    "b_ih": ("bias_ih", False),
    "b_hh": ("bias_hh", False),
    "noise": ("noise", False),
    "decay": ("decay", False),
    "wet": ("wet", False),
}


def flax_to_state_dict(tree: dict) -> dict:
    """Nested dict of numpy arrays (a flax param tree) → flat state_dict of
    float32 torch tensors."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,))
                continue
            if key not in _LEAF:
                raise KeyError(f"unknown parameter leaf {'.'.join(prefix + (key,))}")
            name, transpose = _LEAF[key]
            arr = np.asarray(value, np.float32)
            if transpose:
                arr = arr.T
            # np.array, not np.ascontiguousarray: the latter makes 0-d leaves 1-d
            out[".".join(prefix + (name,))] = torch.tensor(np.array(arr, order="C"))

    walk(tree, ())
    return out


# state_dict leaf name → flax leaf name; a 2-D `weight` is a Dense kernel
# (transposed), a 1-D one a LayerNorm scale
_FLAX_LEAF = {
    "bias": ("bias", False),
    "weight_ih": ("w_ih", True),
    "weight_hh": ("w_hh", True),
    "bias_ih": ("b_ih", False),
    "bias_hh": ("b_hh", False),
    "noise": ("noise", False),
    "decay": ("decay", False),
    "wet": ("wet", False),
}


def state_dict_to_flax(state_dict: dict) -> dict:
    """Flat state_dict (tensors, any device) → nested dict of float32 numpy
    arrays in the flax tree's layout: the inverse of flax_to_state_dict,
    used to compare parameters or gradients leaf by leaf with the JAX
    package (utils/torch_reference.py:31-64)."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            name, transpose = ("kernel", True) if arr.ndim == 2 else ("scale", False)
        elif leaf in _FLAX_LEAF:
            name, transpose = _FLAX_LEAF[leaf]
        else:
            raise KeyError(f"unknown parameter leaf {key}")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.array(arr.T if transpose else arr, order="C")
    return tree
