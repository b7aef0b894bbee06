"""The FLYP train step: both towers forward, the contrastive loss, backward
and an AdamW update.

Counterpart of ``flyp_tpu/training/train_step.py``.  The update semantics are the reference's: per-item loss -> mean -> backward ->
AdamW step -> scheduler step (folded into the schedule).  The step runs the
model in training mode whatever its mode (the JAX step's ``train=True``;
every transformer block runs the attention-block training kernels, forward
B1 and backward B2, on the card) and restores its mode afterwards.  The step launches work and returns: its
metrics stay on the device until the caller fetches them.

On a mesh (``parallel/mesh.py``) each rank runs its rows of the global
batch; the contrastive loss gathers the features over the batch axes
(``ops/losses.py``), each rank backpropagates its share of the global mean,
and the gradients are summed over the batch axes in a few flat buckets
(reduce-scattered to the shards under FSDP).  The model axis needs no
reduction here: the tensor-parallel blocks sum their partial products and
LayerNorm gradients themselves, so a replicated parameter's gradient is
whole on every rank, and a sharded one's is its shard's.

Under a profiler the step records spans (``utils/profiling.py::span``):
``step``, with the step number as its root id, and inside it
``step.forward`` (both towers and the loss), ``step.backward``,
``step.grad_sync`` (on a mesh, with the bytes handed to the exchange) and
``step.update``, each timed on the device's stream.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.models.resnet import synced_batch_norm
from flyp_tpu_torch.ops.losses import clip_loss
from flyp_tpu_torch.training.train_state import AdamW, TrainState
from flyp_tpu_torch.utils.profiling import span


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def sharded_global_norm(state: TrainState, grads) -> torch.Tensor:
    """The global gradient norm of a state on a mesh: a sharded parameter's
    squares summed over the axis it is split along, every tensor counted
    once."""
    from flyp_tpu_torch.parallel.comm import all_reduce_, sum_of_squares

    if not state.layout:
        return global_norm(grads)
    names = [name for name, _ in state.model.named_parameters()]
    device = grads[0].device
    total = sum_of_squares([g for n, g in zip(names, grads) if n not in state.layout], device)
    for axis in sorted({a for a, _ in state.layout.values()}):
        part = sum_of_squares([g for n, g in zip(names, grads) if state.layout.get(n, (None,))[0] == axis], device)
        total = total + all_reduce_(part, state.mesh.group(axis))
    return torch.sqrt(total)


def batch_groups(mesh):
    """``(n, group, replica)`` of a step on ``mesh``: the ranks the batch
    is split over, their process group (None for one rank) and the replica
    axis's group (None without one)."""
    from flyp_tpu_torch.parallel.mesh import REPLICA_AXIS, batch_axes

    if mesh is None or mesh.size == 1:
        return 1, None, None
    replica = mesh.group(REPLICA_AXIS) if REPLICA_AXIS in mesh.axis_names else None
    return mesh.axis_size(batch_axes(mesh)), mesh.group(batch_axes(mesh)), replica


def frozen_mask(model: CLIPModel, freeze_encoder: bool) -> List[bool]:
    """Per parameter, in ``model.parameters()`` order: True for the image
    tower's when it is frozen."""
    return [freeze_encoder and name.startswith("visual.") for name, _ in model.named_parameters()]


def apply_gradients(state: TrainState, grads, optimizer: AdamW, frozen: Sequence[bool], *, loss: torch.Tensor,
                    per_item: torch.Tensor, log_grad_norm: bool):
    """The update tail of the direct and the chunked step: the AdamW update
    (frozen parameters keep their values), the step count and the metrics."""
    with span("step.update", stream_of=grads[0]):
        lr = optimizer.update(state.update_targets, grads, state.opt_state, frozen=frozen)
    state.step += 1
    metrics: Dict[str, torch.Tensor] = {
        "loss": loss.detach(), "per_item_loss": per_item.detach(), "learning_rate": lr,
    }
    if log_grad_norm:
        metrics["grad_norm"] = sharded_global_norm(state, grads)
    return state, metrics


def sync_grads(state: TrainState, grads, group, replica):
    """The gradient exchange of a step on a mesh: the batch axes' sums,
    reduce-scattered to the shards under FSDP."""
    from flyp_tpu_torch.parallel import comm, fsdp

    with span("step.grad_sync", stream_of=grads[0]) as s:
        if s is not None:
            s.attrs["bytes"] = sum(g.numel() * g.element_size() for g in grads)
        if state.shards is not None:
            return fsdp.reduce_scatter_grads(state, grads, replica_group=replica)
        return comm.all_reduce_flat(grads, group)


def make_train_step(
    model: CLIPModel,
    optimizer: AdamW,
    *,
    ignore: bool = False,
    google_sup_loss: bool = False,
    use_ground_labels: bool = False,
    log_grad_norm: bool = False,
    freeze_encoder: bool = False,
    grad_cache_chunks: int = 1,
    mesh=None,
) -> Callable:
    """Build ``step_fn(state, images, tokens[, ground_labels]) -> (state,
    metrics)``.

    ``images`` ``[B, H, W, 3]`` and ``tokens`` ``[B, ctx]`` (ids, optionally
    shrunk by ``shrink_context``) lie on the model's device.  ``metrics``
    holds the mean ``loss``, the ``per_item_loss`` (a scalar for the
    supervised variants), the ``learning_rate`` used and, with
    ``log_grad_norm``, the global ``grad_norm``; all stay on the device.
    The state is updated in place and returned.  A ModifiedResNet's
    BatchNorm runs in training mode: batch statistics, and running
    statistics updated in place (under ``freeze_encoder`` too, as in JAX).

    ``freeze_encoder``: the image tower trains no further.  Its grads are
    zero (its Adam moments take zeros) and its updates are discarded, the
    decoupled weight decay included; its backward is never run.
    ``ignore``/``google_sup_loss``/``use_ground_labels`` select the
    supervised loss variants (:func:`clip_loss`).  ``grad_cache_chunks >
    1`` builds the chunked step of ``training/grad_cache.py``: the same
    objective through that many microbatches.

    ``mesh``: the step of one rank of a multi-rank mesh (module docstring);
    ``images`` and ``tokens`` are then this rank's rows of the global batch
    (``parallel/mesh.py::shard_batch``), ``loss`` is the global batch's and
    ``per_item_loss`` this rank's rows' (the supervised variants: the
    global scalar).  The state must have been placed on the same mesh (TP,
    FSDP or replicated).  A ModifiedResNet's BatchNorm normalises with the
    global batch's statistics there (``models/resnet.py::synced_batch_norm``
    over the batch axes), and its running statistics stay equal on every
    rank.
    """
    if grad_cache_chunks < 1:
        raise ValueError(f"grad_cache_chunks must be >= 1, got {grad_cache_chunks}")
    multi = mesh is not None and mesh.size > 1
    if grad_cache_chunks > 1:
        from flyp_tpu_torch.training.grad_cache import make_chunked_train_step

        return make_chunked_train_step(
            model, optimizer, chunks=grad_cache_chunks, ignore=ignore, google_sup_loss=google_sup_loss,
            use_ground_labels=use_ground_labels, log_grad_norm=log_grad_norm, freeze_encoder=freeze_encoder,
            mesh=mesh,
        )
    from flyp_tpu_torch.parallel import comm, fsdp

    n_batch, group, replica = batch_groups(mesh)
    frozen = frozen_mask(model, freeze_encoder)

    def step_fn(state: TrainState, images: torch.Tensor, tokens: torch.Tensor, ground_labels=None):
        if state.model is not model:
            raise ValueError("the state holds another model than the one this step was built for")
        if multi and state.mesh is not mesh:
            raise ValueError("the state was placed on another mesh than the one this step was built for")
        with span("step", root=state.step):
            return _step(state, images, tokens, ground_labels)

    def _step(state: TrainState, images: torch.Tensor, tokens: torch.Tensor, ground_labels):
        is_fsdp = state.shards is not None
        if is_fsdp:
            fsdp.materialize(state)
        params = state.params
        # The JAX step's train=True, whatever the model's mode.
        with pinned_mode(model, train=True), synced_batch_norm(model, group):
            with span("step.forward", stream_of=images):
                img_f, txt_f, scale = model(images, tokens)
                per_item = clip_loss(
                    img_f, txt_f, scale, ground_labels if use_ground_labels else None,
                    ignore=ignore, google_sup_loss=google_sup_loss, group=group, local_loss=multi,
                )
                if per_item.dim() == 0:
                    # A supervised scalar, the same on every rank: each backpropagates 1/n of it.
                    objective, loss = per_item / n_batch, per_item
                elif not multi:
                    objective = loss = per_item.mean()
                else:
                    # This rank's rows' share of the global mean.
                    b_global = per_item.shape[0] * n_batch
                    objective = per_item.sum() / b_global
                    loss = comm.all_reduce_(per_item.detach().sum(), group) / b_global
            trained = [p for p, f in zip(params, frozen) if not f]
            with span("step.backward", stream_of=images):
                it = iter(torch.autograd.grad(objective, trained))
        grads = [torch.zeros_like(p) if f else next(it) for p, f in zip(params, frozen)]
        if is_fsdp or multi:
            grads = sync_grads(state, grads, group, replica)
        out = apply_gradients(state, grads, optimizer, frozen, loss=loss, per_item=per_item,
                              log_grad_norm=log_grad_norm)
        if is_fsdp:
            fsdp.release(state)
        return out

    return step_fn
