"""Input sharding over processes.

Counterpart of ``flyp_tpu/parallel/multihost.py``.  Each process loads its
own slice of the global batch (the CSV and tar loaders shard by the input
grid); the grid comes from the mesh (:func:`configure_input_sharding`): the
processes that hold the same batch shards form one input group and load the
same rows.  On a tensor-parallel mesh the ranks of one model group are one
input group, so with ``model == world`` every process loads the whole batch.
Without a pinned grid it is the process grid of ``torch.distributed``
(``(0, 1)`` without a process group), right for pure data parallelism.

In torch the "global array" of the JAX package (``global_batch_from_local``)
is each rank's local slice: the rows a rank's input group loaded are the
rows of the global batch that ``parallel/mesh.py::shard_batch`` gives it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


def _dist():
    """``torch.distributed`` when a process group is initialised, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


#: (rank, count) input-sharding grid pinned by configure_input_sharding().
_INPUT_GRID: Optional[tuple] = None


def _mesh_batch_grid(mesh, process_of: Optional[Callable[[Any], int]] = None,
                     me: Optional[int] = None) -> tuple:
    """The input-sharding grid from which batch shards each process's
    devices hold.  ``process_of`` maps an entry of ``mesh.devices`` to its
    process (default: the entry is the rank, one device a process); ``me``
    is this process (default: this rank).

    Processes whose devices hold the same set of batch shards form one
    input group; groups are ranked by their first shard, so group r
    supplies rows ``[r k, (r + 1) k)`` of the shards.  A layout that gives
    one group shards that are not contiguous is refused."""
    import numpy as np

    from flyp_tpu_torch.parallel.mesh import batch_axes

    process_of = process_of or (lambda d: int(d))
    axes = batch_axes(mesh)
    arr = np.asarray(mesh.devices)
    names = list(mesh.axis_names)
    batch_dims = [names.index(a) for a in axes]
    other_dims = [i for i in range(arr.ndim) if i not in batch_dims]
    blocks = arr.transpose(batch_dims + other_dims).reshape(
        int(np.prod([arr.shape[d] for d in batch_dims])), -1
    )
    held: Dict[int, set] = {}
    for b in range(blocks.shape[0]):
        for dev in blocks[b]:
            held.setdefault(process_of(dev), set()).add(b)
    groups: Dict[frozenset, list] = {}
    for p, bs in held.items():
        groups.setdefault(frozenset(bs), []).append(p)
    ranked = sorted(groups, key=min)
    n, k = blocks.shape[0], blocks.shape[0] // len(ranked)
    for r, sig in enumerate(ranked):
        if sig != frozenset(range(r * k, (r + 1) * k)):
            raise ValueError(
                f"mesh device layout assigns non-contiguous batch shards "
                f"{sorted(sig)} of {n} to one process group; input sharding "
                "cannot reconstruct the global batch from per-process slices"
            )
    me = process_index() if me is None else me
    (rank,) = [r for r, sig in enumerate(ranked) if me in groups[sig]]
    return rank, len(ranked)


def configure_input_sharding(mesh) -> tuple:
    """Pin the input-sharding grid for ``mesh``; call after building the
    trainer's mesh and before building sharded train loaders, and
    :func:`reset_input_sharding` when the run ends.  Returns the (rank,
    count) grid.  A single process does not pin (the process grid is
    already right)."""
    global _INPUT_GRID
    _INPUT_GRID = None if process_count() == 1 else _mesh_batch_grid(mesh)
    return _INPUT_GRID if _INPUT_GRID is not None else (0, 1)


def reset_input_sharding() -> None:
    """Unpin the grid (the trainer calls it on every exit path)."""
    global _INPUT_GRID
    _INPUT_GRID = None


def input_shard_grid() -> tuple:
    """The active (rank, count) grid for input sharding: the mesh-derived
    grid when a trainer pinned one, else the process grid."""
    if _INPUT_GRID is not None:
        return _INPUT_GRID
    return process_index(), process_count()


def resolve_process(
    index: int | None = None, count: int | None = None, shard_by_process: bool = True
) -> tuple[int, int]:
    """(rank, count) for input sharding: an explicit override (tests simulate
    ``count > 1`` on one host) wins, else the input grid, but only when
    ``shard_by_process`` asks for sharding at all.  Eval loaders pass
    ``False`` so every process iterates the full test set;
    ``shard_by_process=False`` wins over everything, an explicit override
    included."""
    if not shard_by_process:
        return 0, 1
    if count is not None:
        return index or 0, count
    if index is not None:
        raise ValueError("process_index requires an explicit process_count")
    return input_shard_grid()


def is_primary() -> bool:
    """True on the process that owns direct artifact writes (stats TSVs,
    metric sinks, pickles, checkpoint files): rank 0.  Checkpoint saves are
    collective all the same: every rank calls them (they gather the
    shards), rank 0 alone writes."""
    return process_index() == 0


def local_batch_size(global_batch_size: int) -> int:
    """Per-process share of the global batch: ``cfg.batch_size`` is the
    global batch the loss sees, so each input group's loader yields
    ``global / count`` rows, ``count`` the input grid's."""
    _, count = input_shard_grid()
    if global_batch_size % count:
        raise ValueError(
            f"global batch_size {global_batch_size} is not divisible by "
            f"the input-shard count {count}; every input group must "
            "contribute an equal slice"
        )
    return global_batch_size // count
