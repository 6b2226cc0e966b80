"""The ('data', 'time') mesh and the collectives of its time axis.

Port of ddsp_pytorch_tpu/parallel/mesh.py:22-39.  A JAX mesh is a grid of
devices; this one is a grid of shards, held in one of two ways:

  * in process (`group` None): every shard lives in this process, on one
    device — the counterpart of the JAX suite's virtual 8-device mesh.  The
    data shards are the batch itself; the time shards are stacked along a
    leading shard dimension;
  * across processes (`group` a torch.distributed process group of
    data × time ranks): one shard a process.  Rank r holds data shard
    r // time and time shard r % time, so time neighbours are neighbouring
    ranks.  gloo carries CPU tensors (and CUDA tensors, through the host);
    NCCL carries CUDA tensors, one card a rank.

Every sharded op (parallel/ops.py) takes local tensors with a leading shard
dimension s: the time shards this process holds, all `time` of them in
process and one across processes.  `TimeAxis` gives the shard count, the
global index of the first local shard and three differentiable
collectives — `all_gather`, `shift` (JAX's ppermute by k shards, zeros
where there is no source) and, on the mesh, `psum`.  In process they are
tensor operations along the shard dimension and autograd transposes them;
across processes they are torch.distributed calls inside autograd
functions whose backward is JAX's transpose: all_gather → this rank's
slice of the summed cotangents, shift(k) → shift(−k).  `psum` sums a
per-process partial loss that every rank then backpropagates, so its
backward is the identity: the parameter gradients are summed across the
ranks once, after the backward (parallel/sharding.GradientReducer).
torch.distributed.nn's all_reduce would sum the cotangents too and make
every gradient `world` times too large.

No counterpart is needed for the JAX module's checked_shard_map, _vma or
_sds (shard_map's replication checks), nor for ops/fft.py (shard_map
gradient wrappers): torch.fft's autograd is exact.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllGather(torch.autograd.Function):
    """(1, ...) on each rank of `axis` → (n, ...) in rank order; backward:
    this rank's row of the cotangents summed over the ranks."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        parts = [torch.empty_like(x) for _ in range(axis.n)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=axis.group)
        return grad[axis.first : axis.first + 1], None


class _Shift(torch.autograd.Function):
    """Shard g receives shard g − k's tensor (zeros where g − k is off the
    axis); backward: the cotangents shifted by −k."""

    @staticmethod
    def forward(ctx, x, axis, k):
        ctx.axis, ctx.k = axis, k
        return axis._send_recv(x.contiguous(), k)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis._send_recv(grad.contiguous(), -ctx.k), None, None


class _SumAcrossProcesses(torch.autograd.Function):
    """all_reduce(SUM) of a per-process partial; identity backward (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TimeAxis:
    """The mesh's time axis as seen from this process: `n` shards, of which
    this process holds `count` starting at global index `first`."""

    def __init__(self, n: int, first: int, count: int, group=None, ranks=()):
        self.n = n
        self.first = first
        self.count = count
        self.group = group
        self.ranks = tuple(ranks)  # global rank of each time shard (processes)

    def indices(self, device) -> torch.Tensor:
        """(count,) global indices of the local shards."""
        return torch.arange(self.first, self.first + self.count, device=device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(count, ...) local → (n, ...) every shard's, in order."""
        if self.group is None:
            return x
        return _AllGather.apply(x, self)

    def shift(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """(count, ...) → (count, ...): shard g gets shard g − k's slice,
        zeros where g − k is not a shard (JAX's ppermute by k)."""
        if k == 0:
            return x
        if self.group is not None:
            return _Shift.apply(x, self, k)
        if abs(k) >= self.n:
            return torch.zeros_like(x)
        zeros = torch.zeros_like(x[: abs(k)])
        if k > 0:
            return torch.cat([zeros, x[:-k]], dim=0)
        return torch.cat([x[-k:], zeros], dim=0)

    def _send_recv(self, x: torch.Tensor, k: int) -> torch.Tensor:
        me = self.first
        out = torch.zeros_like(x)
        ops = []
        if 0 <= me + k < self.n:
            ops.append(dist.P2POp(dist.isend, x, self.ranks[me + k], self.group))
        if 0 <= me - k < self.n:
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[me - k], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


class Mesh:
    """A ('data', 'time') mesh of shards, in this process (`group` None) or
    one shard a rank of `group` (parallel/mesh.py:22-39's make_mesh)."""

    def __init__(self, data: int, time: int, group=None):
        if data < 1 or time < 1:
            raise ValueError(f"mesh axes must be ≥ 1, got data={data} time={time}")
        self.data = data
        self.time = time
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
            self.data_index = 0
            self.time_axis = TimeAxis(time, 0, time)
            return
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        if data * time != self.world:
            raise ValueError(
                f"mesh {data}x{time} across processes needs data × time = world size, "
                f"got world size {self.world}"
            )
        self.data_index, time_index = divmod(self.rank, time)
        ranks = dist.get_process_group_ranks(group)
        # every rank creates every data shard's time group, in the same order
        for d in range(data):
            members = [ranks[d * time + t] for t in range(time)]
            g = dist.new_group(members) if time > 1 else None
            if d == self.data_index:
                time_group, time_ranks = g, members
        self.time_axis = TimeAxis(time, time_index, 1, time_group, time_ranks)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "time": self.time}

    @property
    def in_process(self) -> bool:
        return self.group is None

    @property
    def data_procs(self) -> int:
        """Processes along the data axis: each holds 1/data_procs of the
        global batch (1 in process, where the batch is whole)."""
        return 1 if self.group is None else self.data

    @property
    def is_primary(self) -> bool:
        """Rank 0 of the mesh: the process that logs and writes."""
        return self.rank == 0

    def data_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a global-batch tensor (all of them in
        process)."""
        if self.group is None:
            return x
        b = x.shape[0] // self.data
        return x[self.data_index * b : (self.data_index + 1) * b]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a per-process partial over every rank; identity backward."""
        if self.group is None:
            return x
        return _SumAcrossProcesses.apply(x, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a value over every rank, without gradient."""
        if self.group is None:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.group)
        return y / self.world

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def __repr__(self) -> str:
        where = "in process" if self.group is None else f"rank {self.rank} of {self.world}"
        return f"Mesh(data={self.data}, time={self.time}, {where})"


def make_mesh(data: int = -1, time: int = 1, group=None) -> Mesh:
    """A ('data', 'time') mesh (parallel/mesh.py:22-39).

    group None: the in-process mesh, data −1 meaning 1.  A process group
    (e.g. torch.distributed.group.WORLD after init_process_group): one shard
    a rank, data −1 meaning world size // time, as JAX's "all remaining
    devices after the time axis"."""
    time = max(int(time), 1)
    if group is None:
        return Mesh(1 if data == -1 else int(data), time)
    world = dist.get_world_size(group)
    if data == -1:
        if world % time:
            raise ValueError(f"{world} processes not divisible by time={time}")
        data = world // time
    return Mesh(int(data), time, group)

