"""FSDP/ZeRO-style sharding of parameters and AdamW moments over the data
axis.

Counterpart of ``flyp_tpu/parallel/fsdp.py``.  Each tensor is split along
its largest dim that the data axis divides (:func:`fsdp_spec`, the JAX
package's rule); tensors under ``MIN_SHARD_ELEMENTS`` replicate.  Where the
JAX package lets XLA insert the gathers and reduce-scatters, the port
writes them (``training/train_step.py``): the parameters rest as shards in
``TrainState.shards``, the moments beside them; a step all-gathers the
shards into the model's parameters (:func:`materialize`), runs the forward
and backward on the whole parameters, reduce-scatters the gradients to the
shards, updates the shards and frees the whole parameters again
(:func:`release`).  Anything else that reads the model (the zero-shot head,
the evaluation) calls :func:`materialize` first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from flyp_tpu_torch.parallel import comm
from flyp_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from flyp_tpu_torch.parallel.tp import take_shard

#: Parameters smaller than this replicate (gathering them costs more than
#: it saves).
MIN_SHARD_ELEMENTS = 2 ** 15


def fsdp_spec(shape, data_size: int) -> Tuple:
    """Shard the largest divisible dim over the data axis; else replicate.
    Ties go to the first such dim."""
    if not len(shape):
        return ()
    n = 1
    for d in shape:
        n *= d
    if n < MIN_SHARD_ELEMENTS:
        return (None,) * len(shape)
    best = None
    for i, d in enumerate(shape):
        if d % data_size == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return (None,) * len(shape)
    spec = [None] * len(shape)
    spec[best] = DATA_AXIS
    return tuple(spec)


@torch.no_grad()
def shard_train_state_fsdp(mesh: Mesh, state):
    """Shard a ``TrainState`` over the data axis: ``state.shards`` holds this
    rank's shard of every parameter (the parameter itself where it
    replicates), the moments are cut the same way, and the model's sharded
    parameters are freed until :func:`materialize`."""
    n = mesh.shape[DATA_AXIS]
    index = mesh.coords()[DATA_AXIS]
    layout: Dict[str, Tuple[str, int]] = {}
    shards: List[torch.Tensor] = []
    opt = state.opt_state
    for i, (name, p) in enumerate(state.model.named_parameters()):
        spec = fsdp_spec(tuple(p.shape), n)
        dims = [d for d, axis in enumerate(spec) if axis is not None]
        if not dims or n == 1:
            shards.append(p)
            continue
        dim = dims[0]
        layout[name] = (DATA_AXIS, dim)
        shards.append(take_shard(p.data, dim, n, index))
        opt.mu[i] = take_shard(opt.mu[i], dim, n, index)
        opt.nu[i] = take_shard(opt.nu[i], dim, n, index)
    state.mesh, state.layout, state.shards = mesh, layout, shards
    state.full_shapes = {name: tuple(p.shape) for name, p in state.model.named_parameters()}
    release(state)
    return state


def _sharded(state):
    names = [name for name, _ in state.model.named_parameters()]
    return [(i, name, state.layout[name][1]) for i, name in enumerate(names) if name in state.layout]


@torch.no_grad()
def materialize(state) -> None:
    """All-gather the shards into the model's parameters (a no-op while they
    are current).  Collective: every rank of the data axis calls it."""
    if state.shards is None or getattr(state, "materialized", True):
        return
    group = state.mesh.group(DATA_AXIS)
    params = list(state.model.parameters())
    for i, _, dim in _sharded(state):
        params[i].data = comm.all_gather(state.shards[i], group, dim=dim)
    state.materialized = True


@torch.no_grad()
def release(state) -> None:
    """Free the model's whole copies of the sharded parameters (the shards
    stay)."""
    if state.shards is None:
        return
    params = list(state.model.parameters())
    for i, _, _ in _sharded(state):
        params[i].data = params[i].data.new_empty(0)
    state.materialized = False


def reduce_scatter_grads(state, grads: List[torch.Tensor], replica_group=None,
                         bucket_elements: int = 1 << 25) -> List[torch.Tensor]:
    """Whole-parameter gradients -> this rank's shards' gradients summed over
    the data axis (and over ``replica_group``), in flat buckets; the
    replicated parameters' gradients are summed whole."""
    group = state.mesh.group(DATA_AXIS)
    n = comm.group_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    sharded = _sharded(state)
    sharded_ids = {i for i, _, _ in sharded}
    repl = [i for i in range(len(grads)) if i not in sharded_ids]
    summed = comm.all_reduce_flat([grads[i] for i in repl], group, bucket_elements)
    for i, g in zip(repl, summed):
        out[i] = g
    bucket: List[Tuple[int, int]] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        rows = torch.stack([torch.cat([grads[i].chunk(n, dim=d)[j].reshape(-1) for i, d in bucket])
                            for j in range(n)])
        mine = comm.reduce_scatter(rows, group)[0]
        offset = 0
        for i, d in bucket:
            shape = state.shards[i].shape
            k = state.shards[i].numel()
            out[i] = mine[offset:offset + k].view(shape).clone()
            offset += k
        bucket, size = [], 0

    for i, _, dim in sharded:
        k = grads[i].numel()
        if size and size + k > bucket_elements:
            flush()
        bucket.append((i, dim))
        size += k
    flush()
    if replica_group is not None:
        out = comm.all_reduce_flat(out, replica_group, bucket_elements)
    return out
