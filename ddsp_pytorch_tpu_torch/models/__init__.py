"""L1+L2 — synthesizer modules and models (torch.nn).

Registry parity with ddsp_pytorch_tpu/models/__init__.py.  Only the
"single-inst-decoder" is ported so far; "mfcc-autoencoder" waits for a
later slice (ROADMAP.md §1).
"""

from ddsp_pytorch_tpu_torch.models.decoder import DDSPDecoder, GRUDecoder, init_params  # noqa: F401
from ddsp_pytorch_tpu_torch.models.modules import (  # noqa: F401
    FilteredNoise,
    HarmonicSynth,
    Reverb,
)

MODEL_REGISTRY = {"single-inst-decoder": DDSPDecoder}


def load_model(name: str, kwargs: dict):
    """Build a model by registry name from its kwargs (as in a bundle's
    meta.json).  Its weights are placeholders: load a state_dict, or draw
    fresh ones with `init_params(model, generator)`."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported (ported: {sorted(MODEL_REGISTRY)}); "
            "see ROADMAP.md §1"
        )
    kwargs = dict(kwargs)
    if kwargs.pop("dtype", "float32") not in ("float32", None):
        raise NotImplementedError("only float32 models are ported")
    kwargs.pop("use_pallas", None)  # JAX backend switch; the port dispatches on device
    return MODEL_REGISTRY[name](**kwargs)
