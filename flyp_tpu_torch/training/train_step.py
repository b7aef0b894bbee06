"""The FLYP train step: both towers forward, the contrastive loss, backward
and an AdamW update.

Counterpart of ``flyp_tpu/training/train_step.py`` for one device.  The
update semantics are the reference's: per-item loss -> mean -> backward ->
AdamW step -> scheduler step (folded into the schedule).  The step runs the
model in training mode whatever its mode (the JAX step's ``train=True``;
every transformer block runs the attention-block training kernels, forward
B1 and backward B2, on the card) and restores its mode afterwards.  The step launches work and returns: its
metrics stay on the device until the caller fetches them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.ops.losses import clip_loss
from flyp_tpu_torch.training.train_state import AdamW, TrainState


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def frozen_mask(model: CLIPModel, freeze_encoder: bool) -> List[bool]:
    """Per parameter, in ``model.parameters()`` order: True for the image
    tower's when it is frozen."""
    return [freeze_encoder and name.startswith("visual.") for name, _ in model.named_parameters()]


def apply_gradients(state: TrainState, grads, optimizer: AdamW, frozen: Sequence[bool], *, loss: torch.Tensor,
                    per_item: torch.Tensor, log_grad_norm: bool):
    """The update tail of the direct and the chunked step: the AdamW update
    (frozen parameters keep their values), the step count and the metrics."""
    lr = optimizer.update(state.params, grads, state.opt_state, frozen=frozen)
    state.step += 1
    metrics: Dict[str, torch.Tensor] = {
        "loss": loss.detach(), "per_item_loss": per_item.detach(), "learning_rate": lr,
    }
    if log_grad_norm:
        metrics["grad_norm"] = global_norm(grads)
    return state, metrics


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
    """
    if grad_cache_chunks < 1:
        raise ValueError(f"grad_cache_chunks must be >= 1, got {grad_cache_chunks}")
    if grad_cache_chunks > 1:
        from flyp_tpu_torch.training.grad_cache import make_chunked_train_step

        return make_chunked_train_step(
            model, optimizer, chunks=grad_cache_chunks, ignore=ignore, google_sup_loss=google_sup_loss,
            use_ground_labels=use_ground_labels, log_grad_norm=log_grad_norm, freeze_encoder=freeze_encoder,
        )
    frozen = frozen_mask(model, freeze_encoder)

    def step_fn(state: TrainState, images: torch.Tensor, tokens: torch.Tensor, ground_labels=None):
        if state.model is not model:
            raise ValueError("the state holds another model than the one this step was built for")
        params = state.params
        with pinned_mode(model, train=True):  # the JAX step's train=True, whatever the model's mode
            img_f, txt_f, scale = model(images, tokens)
            per_item = clip_loss(
                img_f, txt_f, scale, ground_labels if use_ground_labels else None,
                ignore=ignore, google_sup_loss=google_sup_loss,
            )
            loss = per_item.mean()
            trained = [p for p, f in zip(params, frozen) if not f]
            it = iter(torch.autograd.grad(loss, trained))
        grads = [torch.zeros_like(p) if f else next(it) for p, f in zip(params, frozen)]
        return apply_gradients(state, grads, optimizer, frozen, loss=loss, per_item=per_item,
                               log_grad_norm=log_grad_norm)

    return step_fn
