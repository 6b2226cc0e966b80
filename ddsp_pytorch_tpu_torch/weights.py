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
    arrays (float64 ones stay float64) in the flax tree's layout: the
    inverse of flax_to_state_dict, used to compare parameters or gradients
    leaf by leaf with the JAX package (utils/torch_reference.py:31-64)."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        dtype = torch.float64 if value.dtype == torch.float64 else torch.float32
        arr = value.detach().to("cpu", dtype).numpy()
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


# CREPE (models/crepe.py): flax leaf → (state_dict leaf, axes permutation)
#   conv kernel (k, in, out) → weight (out, in, k); both cross-correlate
#   Dense kernel (in, out)   → weight (out, in)
#   BatchNorm scale, bias    → weight, bias; batch_stats mean, var →
#                              running_mean, running_var
_CREPE_PARAM = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_CREPE_STAT = {"mean": "running_mean", "var": "running_var"}


def crepe_state_dict_from_flax(tree: dict) -> dict:
    """A CREPE `{params, batch_stats}` tree (numpy, as msgpack_restore
    gives it) → the state_dict of models/crepe.py's CREPE, float32."""
    out = {}
    for collection, leaves in (("params", _CREPE_PARAM), ("batch_stats", _CREPE_STAT)):
        for layer, node in tree[collection].items():
            for leaf, value in node.items():
                if leaf not in leaves:
                    raise KeyError(f"unknown CREPE leaf {collection}/{layer}/{leaf}")
                arr = np.asarray(value, np.float32)
                if leaf == "kernel":
                    arr = arr.T  # (k, in, out) → (out, in, k); (in, out) → (out, in)
                out[f"{layer}.{leaves[leaf]}"] = torch.tensor(np.array(arr, order="C"))
    return out


def crepe_flax_from_state_dict(state_dict: dict) -> dict:
    """The inverse of crepe_state_dict_from_flax: a CREPE state_dict → the
    `{params, batch_stats}` tree of float32 numpy arrays."""
    tree: dict = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _CREPE_STAT.items()}
    for key, value in state_dict.items():
        layer, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf in stats:
            tree["batch_stats"].setdefault(layer, {})[stats[leaf]] = np.array(arr, order="C")
        elif leaf == "weight":
            name = "scale" if arr.ndim == 1 else "kernel"
            tree["params"].setdefault(layer, {})[name] = np.array(arr.T if arr.ndim > 1 else arr, order="C")
        elif leaf == "bias":
            tree["params"].setdefault(layer, {})["bias"] = np.array(arr, order="C")
        else:
            raise KeyError(f"unknown CREPE state_dict key {key}")
    return tree
