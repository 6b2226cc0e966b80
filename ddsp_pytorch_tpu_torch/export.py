"""Bundle → model → StreamingSynth.

Port of ddsp_pytorch_tpu/export/__init__.py:136-157 (`load_bundle`,
`make_streaming_synth`).  The bundle is read through bundle.py: meta.json
for the model and the loudness stats, params.msgpack for the weights.
"""

from __future__ import annotations

from typing import Tuple

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.bundle import read_meta, read_params
from ddsp_pytorch_tpu_torch.models import load_model
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict


def load_bundle(bundle_dir: str, device="cuda") -> Tuple:
    """Load an exported bundle → (model on `device`, in eval mode, meta)."""
    device = resolve_device(device)
    meta = read_meta(bundle_dir)
    model = load_model(meta["model"]["name"], meta["model"]["kwargs"])
    model.load_state_dict(flax_to_state_dict(read_params(bundle_dir)), strict=True)
    return model.to(device).eval(), meta


def make_streaming_synth(bundle_dir: str, batch: int = 1, device="cuda", **kwargs):
    """Bundle → ready StreamingSynth on `device` (kwargs: seed,
    noise_deterministic)."""
    model, meta = load_bundle(bundle_dir, device=device)
    mean = meta.get("mean_loudness")
    std = meta.get("std_loudness")
    return StreamingSynth(
        model,
        mean_loudness=0.0 if mean is None else mean,
        std_loudness=1.0 if std is None else std,
        batch=batch,
        device=device,
        **kwargs,
    )
