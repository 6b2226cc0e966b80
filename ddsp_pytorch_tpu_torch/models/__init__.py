"""L1+L2 — synthesizer modules and models (torch.nn).

Registry parity with ddsp_pytorch_tpu/models/__init__.py: the
"single-inst-decoder" and the "mfcc-autoencoder"; and "rave-v1"
(models/rave.py), which the JAX package does not have.
"""

import torch

from ddsp_pytorch_tpu_torch.models.decoder import DDSPDecoder, GRUDecoder, init_params  # noqa: F401
from ddsp_pytorch_tpu_torch.models.encoder import DDSPAutoencoder, MFCCEncoder  # noqa: F401
from ddsp_pytorch_tpu_torch.models.modules import (  # noqa: F401
    FilteredNoise,
    HarmonicSynth,
    Reverb,
)
from ddsp_pytorch_tpu_torch.models.rave import RAVE  # noqa: F401

MODEL_REGISTRY = {"single-inst-decoder": DDSPDecoder, "mfcc-autoencoder": DDSPAutoencoder, "rave-v1": RAVE}
# `model.kwargs.dtype` as a config or a bundle's meta.json carries it → the
# NN's compute dtype (None: the parameters' own type)
COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}

# after COMPUTE_DTYPES, which models/crepe.py reads from this package
from ddsp_pytorch_tpu_torch.models.crepe import CREPE, extract_pitch_crepe  # noqa: E402,F401


def load_model(name: str, kwargs: dict):
    """Build a model by registry name from its kwargs (as in a bundle's
    meta.json).  `dtype` ("float32", "bfloat16" or None) is the NN's
    compute dtype, as in ddsp_pytorch_tpu/models/__init__.py:45-46; the
    parameters are float32 either way.  Its weights are placeholders: load
    a state_dict, or draw fresh ones with `init_params(model, generator)`."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported (ported: {sorted(MODEL_REGISTRY)}); "
            "see ROADMAP.md §1"
        )
    kwargs = dict(kwargs)
    dtype = kwargs.pop("dtype", None)
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"model dtype {dtype!r} is not one of {sorted(k for k in COMPUTE_DTYPES if k)}")
    kwargs.pop("use_pallas", None)  # JAX backend switch; the port dispatches on device
    return MODEL_REGISTRY[name](**kwargs, compute_dtype=COMPUTE_DTYPES[dtype])
