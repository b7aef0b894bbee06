"""The chunked contrastive train step (GradCache; Gao et al. 2021,
arXiv:2101.06983): the exact big-batch InfoNCE objective with the
activations of one microbatch at a time.

Counterpart of ``flyp_tpu/training/grad_cache.py``.  The towers meet only
through the ``[B, D]`` feature matrices, so the step runs in three passes:

1. **Features**: each of the M microbatches through both towers under
   ``torch.no_grad()`` in training mode; its activations are freed when the
   next one starts.  A ModifiedResNet normalises each microbatch with its own
   batch statistics (as the reference's per-GPU ``nn.DataParallel`` BatchNorm
   does), and its running statistics chain from chunk to chunk.
2. **Loss**: :func:`clip_loss` on the whole ``[B, D]`` features, held as
   leaf tensors, gives the feature cotangents and the scale's.
3. **Gradients**: each microbatch's forward again, with autograd, pulled
   back with its slice of the feature cotangents and ``1/M`` of the scale's
   (the chunks' contributions sum to the whole), the gradients summed over
   the chunks.  The running statistics are not written a second time: the
   forward uses batch statistics only (``models/resnet.py::
   running_stats_frozen``), so its features are those of pass 1.

The forward runs twice, so a chunked step does about 4/3 of a direct step's
work; its peak memory is one microbatch's activations plus the ``B x B``
logits.
"""

from __future__ import annotations

from typing import Callable

import torch

from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.models.resnet import running_stats_frozen
from flyp_tpu_torch.ops.losses import clip_loss
from flyp_tpu_torch.training.train_state import AdamW, TrainState
from flyp_tpu_torch.training.train_step import apply_gradients, frozen_mask


def make_chunked_train_step(
    model: CLIPModel,
    optimizer: AdamW,
    *,
    chunks: int,
    ignore: bool = False,
    google_sup_loss: bool = False,
    use_ground_labels: bool = False,
    log_grad_norm: bool = False,
    freeze_encoder: bool = False,
) -> Callable:
    """A chunked step with :func:`make_train_step`'s interface and metrics:
    ``step_fn(state, images, tokens[, ground_labels]) -> (state, metrics)``;
    the batch must divide by ``chunks``.

    ``freeze_encoder``: pass 3 runs the text tower and the scale alone, so
    the image tower's backward never runs; its grads are zero and its
    updates discarded, as in the direct step."""
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    frozen = frozen_mask(model, freeze_encoder)

    def step_fn(state: TrainState, images: torch.Tensor, tokens: torch.Tensor, ground_labels=None):
        if state.model is not model:
            raise ValueError("the state holds another model than the one this step was built for")
        b = images.shape[0]
        if b % chunks:
            raise ValueError(f"batch {b} is not divisible by {chunks} grad-cache chunks")
        m = b // chunks
        imgs, toks = images.split(m), tokens.split(m)
        params = state.params
        trained = [p for p, f in zip(params, frozen) if not f]
        with pinned_mode(model, train=True):
            # Pass 1: features only; running statistics chain chunk to chunk.
            with torch.no_grad():
                feats = [model(im, tk) for im, tk in zip(imgs, toks)]
            img_f = torch.cat([f[0] for f in feats]).requires_grad_()
            txt_f = torch.cat([f[1] for f in feats]).requires_grad_()
            scale = feats[0][2].clone().requires_grad_()  # a parameter's exp: equal in every chunk
            del feats

            # Pass 2: the whole batch's loss on the [B, D] features.
            per_item = clip_loss(img_f, txt_f, scale, ground_labels if use_ground_labels else None,
                                 ignore=ignore, google_sup_loss=google_sup_loss)
            loss = per_item.mean()
            g_img, g_txt, g_scale = torch.autograd.grad(loss, [img_f, txt_f, scale])
            g_scale = g_scale / chunks

            # Pass 3: each chunk's forward pulled back with its cotangents.
            acc = None
            with running_stats_frozen(model):
                for im, tk, gi, gt in zip(imgs, toks, g_img.split(m), g_txt.split(m)):
                    if freeze_encoder:
                        outs = (model.encode_text(tk, normalize=True), torch.exp(model.logit_scale))
                        cots = (gt, g_scale)
                    else:
                        outs, cots = model(im, tk), (gi, gt, g_scale)
                    g = torch.autograd.grad(outs, trained, cots)
                    if acc is None:
                        acc = list(g)
                    else:
                        torch._foreach_add_(acc, g)
                    del outs, g
        it = iter(acc)
        grads = [torch.zeros_like(p) if f else next(it) for p, f in zip(params, frozen)]
        return apply_gradients(state, grads, optimizer, frozen, loss=loss, per_item=per_item,
                               log_grad_norm=log_grad_norm)

    return step_fn
