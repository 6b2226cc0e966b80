"""ddsp_pytorch_tpu_torch — the PyTorch/CUDA port of ddsp_pytorch_tpu.

The JAX package `ddsp_pytorch_tpu` is the reference; this package restates
its serving path in PyTorch for an NVIDIA Hopper GPU:

  bundle.py     flax msgpack + meta.json bundle reader (stdlib + numpy)
  weights.py    flax parameter tree → this package's state_dict
  ops/          L0 DSP core: oscillator bank (hand-written CUDA kernel on
                CUDA tensors, plain PyTorch on CPU tensors), FIR noise, FFTs
  models/       L1+L2 HarmonicSynth / FilteredNoise / Reverb, GRU decoder
  streaming/    L6a exact-state block streaming
  export.py     bundle → model → StreamingSynth
  serve.py      socket server, wire-compatible with ddsp_pytorch_tpu.serve

It imports torch, numpy and the standard library only — never jax, flax,
msgpack, yaml or ddsp_pytorch_tpu.  Entry points take an explicit `device`
(default "cuda") and raise when CUDA is missing; nothing falls back to the
CPU unless the caller asks for it.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none.

    Only "cpu" and "cuda" devices are supported.  There is deliberately no
    fallback: a caller that wants the CPU path passes device="cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev
