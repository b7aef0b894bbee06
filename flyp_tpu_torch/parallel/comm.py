"""The collectives of the port's parallel layer, over the mesh's process
groups (``parallel/mesh.py``).

The JAX package writes global math and lets XLA place the collectives; the
port calls them here.  Every function takes a process group, or None for
an axis of one rank, where it is the identity.  The differentiable ones
carry their transposes as JAX's do:

* :func:`gather_rows`: ``all_gather(tiled=True)`` along the first dim;
  backward, the reduce-scatter (sum) of the gathered gradient;
* :func:`reduce_from_group`: ``psum`` (Megatron's "g"); backward, the
  identity;
* :func:`copy_to_group`: the identity (Megatron's "f"); backward, the
  ``psum`` of the gradient;
* :func:`gather_shards`: the all-gather of a sharded weight that every rank
  then uses whole on the same replicated input (GSPMD's gather in front of
  a kernel with no partitioning rule); backward, this rank's slice of the
  gradient, which every rank computed whole.

The sums over the group that a layer needs inside its own backward (the
BatchNorm of ``models/resnet.py`` over the batch axes) call
:func:`all_reduce_` there: the transpose of an all-reduce of statistics of
different rows on each rank is the sum over the group, not
:func:`reduce_from_group`'s identity, which holds only for a computation
that every rank repeats.

Every collective takes its tensors where they lie, under ``nccl`` and
``gloo`` alike (gloo stages CUDA tensors through the host itself).
:func:`max_int`, the host's agreement on a number, runs on CPU tensors
over :func:`host_group`, so it never waits for the device.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def _dist():
    import torch.distributed as dist

    return dist


def group_size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else _dist().get_rank(group)


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce (``sum`` or ``max``) of ``t`` over ``group``."""
    if group is None:
        return t
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=red, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    _dist().all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of ``t`` ``[n * b, ...]``, this rank's rows
    ``[b, ...]`` (the row blocks in group-rank order)."""
    if group is None:
        return t
    n = group_size(group)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} ranks")
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    _dist().reduce_scatter(out, [c.contiguous() for c in t.chunk(n)], group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=0)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n, i = group_size(ctx.group), group_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[i].contiguous(), None, None


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable all-gather of a weight shard along ``dim`` into the
    whole weight, for a computation every rank of the group repeats on the
    same input: each rank's gradient is its own slice of the whole
    gradient (a reduce-scatter would count it once a rank)."""
    return x if group is None else _GatherShards.apply(x, group, dim)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather of ``x`` ``[b, ...]`` into ``[n b, ...]``:
    each rank's gradient is the group's summed gradient of its own rows."""
    return x if group is None else _GatherRows.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable ``psum``: forward the group's sum, backward the
    identity (each rank's gradient of a replicated result is whole)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Forward the identity, backward the group's sum of the gradient: the
    entry of a tensor-parallel region whose ranks each use ``x`` for part
    of their work."""
    return x if group is None else _CopyToGroup.apply(x, group)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group, bucket_elements: int = 1 << 25) -> List[torch.Tensor]:
    """The group's sums of ``tensors`` (same dtype and device), in flat
    buckets of up to ``bucket_elements``: a few collectives, not one per
    tensor.  Returns new tensors; the inputs are left as they were."""
    out = [t.clone() for t in tensors]
    if group is None or not out:
        return out
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        all_reduce_(flat, group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket, size = [], 0

    for t in out:
        if size and size + t.numel() > bucket_elements:
            flush()
        bucket.append(t)
        size += t.numel()
    flush()
    return out


def sum_of_squares(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """fp32 sum of the squares of every element (0 for no tensors)."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sum()


_HOST_GROUP = {}


def host_group():
    """A ``gloo`` group of every rank, for CPU tensors: None (the default
    group) where that is gloo, else one made on the first call after the
    process group was set up (a collective call: ``parallel/mesh.py``
    makes it with a mesh's groups, at the same point on every rank)."""
    dist = _dist()
    if dist.get_backend() == "gloo":
        return None
    group = _HOST_GROUP.get("gloo")
    if group is None or group not in dist.distributed_c10d._world.pg_map:  # none yet, or destroyed
        group = _HOST_GROUP["gloo"] = dist.new_group(backend="gloo")
    return group


def max_int(value: int) -> int:
    """The largest ``value`` over every rank of the process group; ``value``
    itself on one process.  A CPU tensor over :func:`host_group`: the
    ranks agree without waiting for their devices."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return int(t.item())
