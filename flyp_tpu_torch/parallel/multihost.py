"""Input sharding over processes: the single-process half.

Counterpart of ``flyp_tpu/parallel/multihost.py``.  The process grid comes
from ``torch.distributed`` when a process group is initialised, and is
``(0, 1)`` otherwise.  The mesh-derived grid (``configure_input_sharding``)
and the assembly of a global batch from per-process slices
(``global_batch_from_local``) wait for ROADMAP A9.
"""

from __future__ import annotations


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


def input_shard_grid() -> tuple[int, int]:
    """The active (rank, count) grid for input sharding: the process grid
    (correct for pure data parallelism, where batch shards and processes
    coincide)."""
    return process_index(), process_count()


def resolve_process(
    index: int | None = None, count: int | None = None, shard_by_process: bool = True
) -> tuple[int, int]:
    """(rank, count) for input sharding: an explicit override (tests simulate
    ``count > 1`` on one host) wins, else the process grid, but only when
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
    metric sinks): rank 0."""
    return process_index() == 0


def local_batch_size(global_batch_size: int) -> int:
    """Per-process share of the global batch: ``cfg.batch_size`` is the
    global batch the loss sees, so each process's loader yields
    ``global / count`` rows."""
    _, count = input_shard_grid()
    if global_batch_size % count:
        raise ValueError(
            f"global batch_size {global_batch_size} is not divisible by "
            f"the input-shard count {count}; every input group must "
            "contribute an equal slice"
        )
    return global_batch_size // count
