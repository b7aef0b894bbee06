"""The device mesh over ``torch.distributed`` ranks, one rank a device.

Counterpart of ``flyp_tpu/parallel/mesh.py``.  A mesh lays the ranks out on
the axes ``(replica, model, data)``: ``data`` innermost in rank order (the
batch shards over it), ``model`` next (ranks that hold complementary head
groups of the tensor-parallel weights, ``parallel/tp.py``), ``replica``
outermost (an outer data-parallel axis; the batch shards over ``replica``
and ``data`` jointly).  The replica axis is built only when it is larger
than 1, so single-replica meshes keep the 2-D ``(model, data)`` shape.

Where the JAX package lets XLA insert the collectives, the port calls them
itself over the process groups of :meth:`Mesh.group`: one group of ranks
for each combination of the other axes' coordinates, made eagerly by every
rank in the same order (``torch.distributed.new_group`` is collective),
after the host's gloo group (``parallel/comm.py::host_group``).  Without an initialised process group a mesh has one rank and no groups,
and every collective of ``parallel/comm.py`` is the identity.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: Outer data-parallel axis (the JAX package's multi-slice axis).
REPLICA_AXIS = "replica"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining ranks
    model: int = 1
    replica: int = 1


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def world_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


class Mesh:
    """Ranks laid out on named axes: ``devices`` is the rank array (the JAX
    ``Mesh.devices`` with ranks for devices), ``shape`` maps each axis to
    its size."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"rank array of shape {self.devices.shape} for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        self._groups: Dict[Tuple[str, ...], object] = {}
        if _dist() is not None and world_size() > 1:
            self._make_groups()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}, ranks={self.devices.ravel().tolist()})"

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The axis coordinates of ``rank`` (default: this process)."""
        rank = world_rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes_tuple(axes)], dtype=np.int64))

    def axis_index(self, axes, rank: Optional[int] = None) -> int:
        """The position of ``rank`` along ``axes`` jointly, the first axis
        outermost: the shard of a tensor split over those axes that it
        holds (``jax.lax.axis_index`` over several axes)."""
        c = self.coords(rank)
        index = 0
        for a in _axes_tuple(axes):
            index = index * self.shape[a] + c[a]
        return index

    def group(self, axes):
        """The process group of this rank along ``axes``, or None where the
        axes hold one rank (every collective over them is the identity)."""
        axes = _axes_tuple(axes)
        if self.axis_size(axes) == 1 or world_size() == 1:
            return None
        return self._groups[self._key(axes)]

    def _key(self, axes) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in axes)

    def _make_groups(self) -> None:
        from flyp_tpu_torch.parallel.comm import host_group

        dist = _dist()
        me = world_rank()
        host_group()
        names = self.axis_names
        combos = [c for r in range(1, len(names) + 1) for c in itertools.combinations(names, r)]
        for axes in combos:
            if self.axis_size(axes) == 1:
                continue
            dims = [names.index(a) for a in axes]
            others = [i for i in range(len(names)) if i not in dims]
            for fixed in itertools.product(*(range(self.devices.shape[i]) for i in others)):
                index = [slice(None)] * len(names)
                for i, v in zip(others, fixed):
                    index[i] = v
                members = self.devices[tuple(index)].reshape(-1).tolist()
                if members != sorted(members):
                    # torch orders a group's ranks by global rank; the
                    # gathers rely on that order being the mesh's.
                    raise ValueError(f"{self}: ranks along {axes} are not in increasing order: {members}")
                group = dist.new_group(members)
                if me in members:
                    self._groups[axes] = group


def _axes_tuple(a) -> Tuple[str, ...]:
    if a is None:
        return ()
    return tuple(a) if isinstance(a, (tuple, list)) else (a,)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dimension shards over, outermost first."""
    if REPLICA_AXIS in mesh.axis_names:
        return (REPLICA_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def create_mesh(config: Optional[MeshConfig] = None, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a ``(replica, model, data)`` mesh over ``ranks`` (default: every
    rank of the process group): ``data`` innermost in rank order, ``model``
    next, ``replica`` outermost and built only when ``config.replica > 1``.
    Every rank must call it, with the same arguments."""
    config = config or MeshConfig()
    ranks = list(ranks if ranks is not None else range(world_size()))
    n = len(ranks)
    model, replica = config.model, config.replica
    data = config.data if config.data != -1 else n // (model * replica)
    if data * model * replica != n:
        raise ValueError(f"mesh {replica}x{data}x{model} does not cover {n} ranks")
    if replica > 1:
        return Mesh(np.array(ranks).reshape(replica, model, data), (REPLICA_AXIS, MODEL_AXIS, DATA_AXIS))
    return Mesh(np.array(ranks).reshape(model, data), (MODEL_AXIS, DATA_AXIS))


def create_mesh_for_batch(config: Optional[MeshConfig], batch_size: int) -> Mesh:
    """Like :func:`create_mesh`, but the data axis is capped at the largest
    size that divides ``batch_size`` over the batch axes; a batch that the
    replica axis does not divide is refused."""
    config = config or MeshConfig()
    n = world_size()
    model, replica = config.model, config.replica
    if replica > 1 and batch_size % replica != 0:
        raise ValueError(
            f"batch_size {batch_size} is not divisible by the replica axis "
            f"({replica}); the batch cannot shard over a multi-replica mesh"
        )
    data = config.data if config.data != -1 else n // (model * replica)
    full_data = n // (model * replica)
    while data > 1 and batch_size % (data * replica) != 0:
        data -= 1
    # The cap slices the data axis within each replica's block of ranks, so
    # a replica never spans two blocks.
    arr = np.arange(replica * model * full_data).reshape(replica, model, full_data)
    ranks = arr[:, :, :data].reshape(-1)
    return create_mesh(MeshConfig(data=data, model=model, replica=replica), ranks=ranks.tolist())


def shard_batch(mesh: Mesh, tree, rank: Optional[int] = None):
    """This rank's rows of a global batch (a tensor, an array or a dict of
    them): the leading axis split over the batch axes, as the JAX package
    places a batch on the mesh.  Non-array entries pass through."""
    axes = batch_axes(mesh)
    n, i = mesh.axis_size(axes), mesh.axis_index(axes, rank)

    def take(x):
        if not hasattr(x, "shape") or not len(x.shape) or getattr(x, "dtype", None) == object:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over {n} batch shards")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    if isinstance(tree, dict):
        return {k: take(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(take(v) for v in tree)
    return take(tree)
