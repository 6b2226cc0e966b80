"""Placement and reduction across the mesh's processes.

Port of ddsp_pytorch_tpu/parallel/sharding.py:1-162, restated for
processes.  JAX places replicated state and data-sharded batches with
NamedShardings and lets XLA insert the gradient psum; here each process
holds its own copy of the state and its slice of the batch, and the
gradients are summed explicitly:

  * replicate_state: every rank takes rank 0's parameters and optimizer
    state (the generators are seeded alike and draw alike);
  * shard_batch / shard_time_batch: this process's slice of a global batch
    — rows over 'data'; for the time-sharded step, sig's samples over
    ('data', 'time') and the frame-rate controls over 'data' only
    (:118-135), padded first where the step pads;
  * GradientReducer: the data-parallel gradient reduction as one flat
    buffer and one all_reduce a step, which NCCL can run inside the
    MultiStep CUDA graph.

On an in-process mesh all of these are the identity: the process holds
every shard.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ddsp_pytorch_tpu_torch.parallel.mesh import Mesh


def replicate_state(state, mesh: Mesh):
    """Broadcast rank 0's parameters and optimizer state to every rank of
    the mesh, in place (sharding.py:27-28).  Returns the state."""
    from ddsp_pytorch_tpu_torch.training.optim import tree_leaves  # training imports this module

    if mesh.in_process:
        return state
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in state.params() + tree_leaves(state.opt_state):
            dist.broadcast(t.data, src=src, group=mesh.group)
    return state


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This process's rows of a global batch (sharding.py:31-47)."""
    return {k: mesh.data_rows(v) for k, v in batch.items()}


def shard_time_batch(batch: Dict[str, torch.Tensor], mesh: Mesh, t_pad: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """This process's slice for the time-sharded step (sharding.py:101-135):
    rows over 'data' for every key; `sig` zero-padded to t_pad samples and
    cut to the span of the local time shards.  The frame-rate controls stay
    whole: the GRU needs every frame."""
    out = shard_batch(batch, mesh)
    sig = out["sig"]
    if t_pad is not None and t_pad > sig.shape[-1]:
        sig = F.pad(sig, (0, t_pad - sig.shape[-1]))
    axis = mesh.time_axis
    chunk = sig.shape[-1] // axis.n
    out["sig"] = sig[..., axis.first * chunk : (axis.first + axis.count) * chunk]
    return out


class GradientReducer:
    """Sum (or average) a step's gradients, and optionally its loss, over
    every rank of a process mesh: one flat buffer, one all_reduce.

    Called inside the step, so a CUDA graph of the step holds the
    collective (NCCL; gloo cannot be captured).  `mean=True` divides by the
    world size (the data-parallel step, whose ranks each took the mean of
    their own rows); `mean=False` sums (the time-sharded step, whose loss is
    already the global mean and whose ranks each hold a part of every
    gradient)."""

    def __init__(self, mesh: Mesh, mean: bool):
        if mesh.in_process:
            raise ValueError("GradientReducer needs a mesh across processes")
        self.mesh = mesh
        self.mean = mean

    def __call__(self, grads: Sequence[torch.Tensor], loss: Optional[torch.Tensor] = None):
        """(reduced grads, reduced loss or None)."""
        parts = [g.reshape(-1) for g in grads]
        if loss is not None:
            parts.append(loss.reshape(1).to(parts[0].dtype))
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=self.mesh.group)
        if self.mean:
            flat = flat / self.mesh.world
        out: List[torch.Tensor] = []
        offset = 0
        for g in grads:
            out.append(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()
        return out, (flat[offset].to(loss.dtype) if loss is not None else None)
