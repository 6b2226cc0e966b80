"""Adam over every leaf of a model in two launches a step — the multi-tensor
wrapper of ops/kernels/adam.cu.

The leaves are cut into chunks of CHUNK elements, one block a (leaf,
chunk), and pass by value as a table (`plan`, `pack`): at most MAX_LEAVES
leaves a launch, so more leaves take more launches, the last of which
finishes the step.  A step launches `adam_norm` (Σ g² into a partial a
block) where it reports the norm or clips, then `adam_update`, which
reads the loss for the NaN guard, Adam's count and the schedule's count,
writes p, mu and nu in place, and whose last block writes the norm and
the counts + 1.  The table is read on the host at each launch: a
captured step replays the addresses it was captured with, and nothing is
copied to the device.

The plain version of the same update is training/optim.py `Optimizer`'s
`update` and the guard's copies, which `Optimizer.apply_` runs where the
leaves are not float32 on a card or the optimizer is SGD.  The JAX
package leaves its optimizer to optax, so these kernels replace no Pallas
kernel.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.ops import kernels

CHUNK = 16384  # elements a block; a multiple of 4 (float4 loads)
MAX_LEAVES = 80  # adam.cu kMaxLeaves: the table below and the scalars fit 4 KB
# adam.cu `Leaves`: MAX_LEAVES int64s each of p, g, mu, nu and the element
# counts, then the first blocks (MAX_LEAVES + 1), the leaves, the first
# partial and a pad as int32s
TABLE_INT64 = 5 * MAX_LEAVES
TABLE_BYTES = 8 * TABLE_INT64 + 4 * (MAX_LEAVES + 4)

# one launch: (the leaves' indices, their first blocks and the launch's
# blocks after the last, the launch's first partial)
Launch = Tuple[List[int], List[int], int]


def plan(numels: Sequence[int], max_leaves: int = MAX_LEAVES, chunk: int = CHUNK) -> List[Launch]:
    """The launches of a step over leaves of `numels` elements, in leaf
    order: empty leaves left out, at most `max_leaves` a launch, one block
    a chunk of `chunk` elements; the partials of all launches in one run."""
    leaves = [i for i, n in enumerate(numels) if n > 0]
    launches, partial0 = [], 0
    for s in range(0, len(leaves), max_leaves):
        part = leaves[s:s + max_leaves]
        first = [0]
        for i in part:
            first.append(first[-1] + -(-int(numels[i]) // chunk))
        launches.append((part, first, partial0))
        partial0 += first[-1]
    return launches


def block_leaf(first: Sequence[int], block: int) -> Tuple[int, int]:
    """(position of the leaf in its launch, chunk of that leaf) of `block`:
    adam.cu leaf_of's binary search, the last leaf whose first block is at
    most `block`."""
    lo, hi = 0, len(first) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= block:
            lo = mid
        else:
            hi = mid - 1
    return lo, block - first[lo]


def pack(launch: Launch, params, grads, mu, nu) -> np.ndarray:
    """One launch's table, adam.cu `Leaves`, as TABLE_BYTES bytes."""
    leaves, first, partial0 = launch
    buf = np.zeros(TABLE_BYTES, np.uint8)
    words = buf[:8 * TABLE_INT64].view(np.int64).reshape(5, MAX_LEAVES)
    for j, i in enumerate(leaves):
        words[:, j] = (params[i].data_ptr(), grads[i].data_ptr(), mu[i].data_ptr(), nu[i].data_ptr(),
                       params[i].numel())
    ints = buf[8 * TABLE_INT64:].view(np.int32)
    ints[:len(first)] = first
    ints[MAX_LEAVES + 1:MAX_LEAVES + 3] = (len(leaves), partial0)
    return buf


def betas(b1: float, b2: float) -> Tuple[float, float, float, float]:
    """(β₁, β₂, 1 − β₁, 1 − β₂) as the kernel takes them: each a float32,
    the complements computed in float64 and rounded once."""
    return tuple(float(np.float32(v)) for v in (b1, b2, 1.0 - b1, 1.0 - b2))


def workspace(numels: Sequence[int], device) -> dict:
    """What `adam_` needs besides its operands for leaves of `numels`: the
    norm's float64 partials, and the done counter, zero between steps
    (the kernel's last block resets it)."""
    launches = plan(numels)
    blocks = launches[-1][2] + launches[-1][1][-1] if launches else 0
    return {"partials": torch.empty(max(blocks, 1), dtype=torch.float64, device=device),
            "done": torch.zeros((), dtype=torch.int32, device=device)}


def adam_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
          nu: Sequence[torch.Tensor], count: torch.Tensor, work: dict, *, lr: float, lr_end: float = 0.0,
          steps: int = 0, schedule_count: Optional[torch.Tensor] = None, clip: Optional[float] = None,
          loss: Optional[torch.Tensor] = None, norm: bool = False, b1: float = 0.9,
          b2: float = 0.999) -> Optional[torch.Tensor]:
    """Adam's step on float32 CUDA leaves, in place: p, mu, nu, `count` and
    `schedule_count` (int32, 0-d), all left as they were where `loss` (a
    0-d float32) is not finite.  `lr`: the constant rate, or (init − end)
    of a linear schedule over `steps` > 0 counts ending at `lr_end`, read
    at `schedule_count`; a `schedule_count` with `steps` 0 counts a
    constant schedule.  `clip`: optax's clip_by_global_norm in front.
    `work`: `workspace(...)` of these leaves.  `b1`, `b2`: Adam's betas,
    passed to the kernel with 1 − b1 and 1 − b2 each computed in float64
    and rounded once to float32 (`betas`), as PyTorch rounds the Python
    floats of training/optim.py's plain path.  Returns the gradients'
    global norm (0-d float32) where `norm`, else None."""
    tensors = {f"{k}{i}": t for k, ts in (("p", params), ("g", grads), ("mu", mu), ("nu", nu))
               for i, t in enumerate(ts)}
    kernels.check_operands({**tensors, "loss": loss})
    if not params[0].is_cuda:
        raise ValueError("adam_ runs on a CUDA device; the CPU takes Optimizer.update")
    for name, t in (("count", count), ("schedule_count", schedule_count)):
        if t is not None and (t.dtype != torch.int32 or t.numel() != 1 or t.device != params[0].device):
            raise TypeError(f"{name} must be a 0-d int32 on {params[0].device}")
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"leaf {i}: shapes {p.shape}, {g.shape}, {m.shape}, {v.shape} differ")
    launches = plan([p.numel() for p in params])
    n_partials = launches[-1][2] + launches[-1][1][-1]
    if work["partials"].numel() < n_partials:
        raise ValueError(f"the workspace holds {work['partials'].numel()} partials, the leaves need {n_partials}")
    tables = [pack(launch, params, grads, mu, nu) for launch in launches]
    clips = clip is not None
    if clips or norm:
        for table, (_, first, _) in zip(tables, launches):
            kernels.launch("adam_norm", table.ctypes.data, work["partials"], first[-1], CHUNK)
    norm_out = torch.empty((), dtype=torch.float32, device=params[0].device) if norm else None
    inv_steps = float(np.float32(1) / np.float32(steps)) if steps > 0 else 0.0
    for k, (table, (_, first, _)) in enumerate(zip(tables, launches)):
        kernels.launch("adam_update", table.ctypes.data, work["partials"], n_partials, norm_out, work["done"],
                       loss, count, schedule_count, lr, lr_end, inv_steps, steps, int(clips),
                       clip if clips else 0.0, *betas(b1, b2), first[-1], CHUNK, int(k == len(launches) - 1))
    return norm_out
