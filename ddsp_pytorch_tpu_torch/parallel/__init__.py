"""L5 — the parallel layer (port of ddsp_pytorch_tpu.parallel): the
('data', 'time') mesh, in process or across torch.distributed processes
(mesh.py), the time-sharded DSP ops (ops.py), placement and the gradient
reduction (sharding.py), and long-form synthesis (longform.py)."""

from ddsp_pytorch_tpu_torch.parallel.longform import LongFormSynthesizer  # noqa: F401
from ddsp_pytorch_tpu_torch.parallel.mesh import Mesh, TimeAxis, make_mesh  # noqa: F401
from ddsp_pytorch_tpu_torch.parallel.sharding import (  # noqa: F401
    GradientReducer,
    replicate_state,
    shard_batch,
    shard_time_batch,
)
