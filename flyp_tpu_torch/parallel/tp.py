"""Tensor-parallel parameter sharding over the mesh's ``model`` axis.

Counterpart of ``flyp_tpu/parallel/tp.py``, with the JAX package's specs on
the port's parameter names (``attn.qkv_kernel`` for ``attn/qkv_kernel``):

* the QKV and MLP-in kernels split their *output* features (column
  parallel): ``qkv_kernel [3, D, D]`` on its last axis, which is head-major,
  so a shard is a group of whole heads; ``qkv_bias`` and ``fc`` with them;
* the attention-out and MLP-out kernels split their *input* features (row
  parallel);
* embeddings, LayerNorms, projections, biases after a row-parallel product
  and scalars replicate.

A spec is a tuple with one entry per dim, ``"model"`` on the sharded dim,
None elsewhere (JAX's ``PartitionSpec``).  :func:`shard_params` replaces a
block's weights by this rank's shard in place and gives the block the model
axis's process group (``models/layers.py`` then runs it tensor-parallel).
A tensor whose sharded dim the axis does not divide replicates, and a whole
block replicates when the axis does not divide its heads (the JAX kernels'
partitioning falls back to the whole block there).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from flyp_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

Spec = Tuple


def _spec_for(path: str, shape) -> Spec:
    """The spec of the parameter named ``path`` (the port's dotted name)."""
    rank = len(shape)
    if path.endswith("attn.qkv_kernel"):
        return (None, None, MODEL_AXIS)  # [3, D, D]: head-major output features
    if path.endswith("attn.qkv_bias"):
        return (None, MODEL_AXIS)  # [3, D], shards with the kernel
    if path.endswith("mlp.fc_kernel"):
        return (None, MODEL_AXIS)  # column parallel
    if path.endswith("mlp.fc_bias"):
        return (MODEL_AXIS,)
    if path.endswith("attn.out_kernel") or path.endswith("mlp.proj_kernel"):
        return (MODEL_AXIS, None)  # row parallel
    return (None,) * rank  # replicate


def clip_param_specs(model: torch.nn.Module) -> Dict[str, Spec]:
    """The spec of every parameter of a CLIP model, by name."""
    return {name: _spec_for(name, p.shape) for name, p in model.named_parameters()}


def _divisible(spec: Spec, shape, n: int) -> bool:
    return all(axis is None or dim % n == 0 for dim, axis in zip(shape, spec))


def _sharded_dim(spec: Spec):
    dims = [i for i, axis in enumerate(spec) if axis is not None]
    return dims[0] if dims else None


def take_shard(t: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    """Shard ``index`` of ``n`` equal pieces of ``t`` along ``dim``, as a
    contiguous copy."""
    return t.chunk(n, dim=dim)[index].contiguous().clone()


@torch.no_grad()
def shard_params(mesh: Mesh, model: torch.nn.Module) -> Dict[str, Tuple[str, int]]:
    """Shard ``model``'s transformer blocks over the model axis in place.
    Returns the layout: ``{name: ("model", dim)}`` for every sharded
    parameter (the rest replicate)."""
    from flyp_tpu_torch.models.layers import ResidualBlock

    n = mesh.shape[MODEL_AXIS]
    layout: Dict[str, Tuple[str, int]] = {}
    if n == 1:
        return layout
    index = mesh.coords()[MODEL_AXIS]
    group = mesh.group(MODEL_AXIS)
    for block_name, block in model.named_modules():
        if not isinstance(block, ResidualBlock) or block.heads % n:
            continue
        sharded = False
        for name, p in block.named_parameters():
            full = f"{block_name}.{name}" if block_name else name
            spec = _spec_for(full, p.shape)
            dim = _sharded_dim(spec)
            if dim is None or not _divisible(spec, p.shape, n):
                continue
            p.data = take_shard(p.data, dim, n, index)
            layout[full] = (MODEL_AXIS, dim)
            sharded = True
        if sharded:
            block.tp_group = group
    return layout


def shard_train_state(mesh: Mesh, state):
    """Shard a ``TrainState`` over the model axis: the parameters (in the
    model) and the AdamW moments, which follow them; the count and the step
    replicate."""
    names = [name for name, _ in state.model.named_parameters()]
    layout = shard_params(mesh, state.model)
    n, index = mesh.shape[MODEL_AXIS], mesh.coords()[MODEL_AXIS] if layout else 0
    opt = state.opt_state
    for i, name in enumerate(names):
        if name in layout:
            dim = layout[name][1]
            opt.mu[i] = take_shard(opt.mu[i], dim, n, index)
            opt.nu[i] = take_shard(opt.nu[i], dim, n, index)
    state.mesh, state.layout = mesh, layout
    return state
