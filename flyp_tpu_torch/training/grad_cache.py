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

On a mesh (``parallel/mesh.py``) chunk ``i`` is the global rows ``[i B/M,
(i+1) B/M)``, split over the batch axes, as the JAX step's ``_split``
constrains it.  The ranks arrive holding contiguous blocks of the global
batch (``shard_batch``), so the step first re-lays the batch: an all-gather
over the batch axes, from which each rank keeps its ``1/n`` of every chunk
(:func:`chunk_rows`).  A ModifiedResNet's BatchNorm then normalises each
chunk with the global chunk's statistics (``models/resnet.py::
synced_batch_norm``), and a ViT sums in the JAX step's order.  Pass 2 runs
on the ``[B, D]`` features gathered over the batch axes in global row order,
the same on every rank; each rank pulls back its own rows' cotangents and
``1/(M n)`` of the scale's (the ranks' and chunks' contributions sum to it).
Pass 3 sums the gradients over the chunks, then once over the batch axes
(one reduce-scatter under FSDP, whose parameters are gathered once for both
passes); tensor-parallel blocks run their own collectives inside each
chunk.
"""

from __future__ import annotations

from typing import Callable

import torch

from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.models.resnet import running_stats_frozen, synced_batch_norm
from flyp_tpu_torch.ops.losses import clip_loss
from flyp_tpu_torch.parallel import comm
from flyp_tpu_torch.training.train_state import AdamW, TrainState
from flyp_tpu_torch.training.train_step import apply_gradients, batch_groups, frozen_mask, sync_grads
from flyp_tpu_torch.utils.profiling import span


def own_rows(whole: torch.Tensor, group, chunks: int) -> torch.Tensor:
    """This rank's ``1/n`` of every one of ``chunks`` chunks of the global
    batch ``whole``, chunk after chunk: the rows ``[i m + r m/n, i m +
    (r+1) m/n)`` of each chunk ``i`` (``m`` rows a chunk, ``r`` this rank's
    place in ``group``)."""
    n = comm.group_size(group)
    parts = whole.view(chunks, n, -1, *whole.shape[1:])
    return parts[:, comm.group_rank(group)].reshape(-1, *whole.shape[1:])


def chunk_rows(x: torch.Tensor, group, chunks: int) -> torch.Tensor:
    """:func:`own_rows` of the global batch, from this rank's contiguous
    block ``x`` of it: an all-gather over ``group`` (the batch axes), then
    the selection."""
    return own_rows(comm.all_gather(x, group), group, chunks)


def global_rows(x: torch.Tensor, group, chunks: int) -> torch.Tensor:
    """The inverse of :func:`chunk_rows` over the whole group: every rank's
    ``[chunks * per, ...]`` rows gathered into the global batch's order."""
    n = comm.group_size(group)
    parts = comm.all_gather(x, group).view(n, chunks, -1, *x.shape[1:])
    return parts.transpose(0, 1).reshape(-1, *x.shape[1:])


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
    mesh=None,
) -> Callable:
    """A chunked step with :func:`make_train_step`'s interface and metrics:
    ``step_fn(state, images, tokens[, ground_labels]) -> (state, metrics)``;
    the batch must divide by ``chunks``.

    ``freeze_encoder``: pass 3 runs the text tower and the scale alone, so
    the image tower's backward never runs; its grads are zero and its
    updates discarded, as in the direct step.

    ``mesh``: the step of one rank of a multi-rank mesh, as
    :func:`make_train_step`'s (module docstring); the inputs are this
    rank's rows, ``per_item_loss`` is this rank's rows' and ``loss`` the
    global batch's.  Each chunk must split evenly over the batch axes
    (``ValueError`` otherwise; the JAX step pads the shards there).

    Under a profiler it records the direct step's ``step``,
    ``step.grad_sync`` and ``step.update`` spans; its passes interleave
    forwards and backwards, so it has no ``step.forward`` or
    ``step.backward``."""
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    from flyp_tpu_torch.parallel import fsdp

    multi = mesh is not None and mesh.size > 1
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
        b_local = images.shape[0]
        b = b_local * n_batch
        if b % chunks:
            raise ValueError(f"batch {b} is not divisible by {chunks} grad-cache chunks")
        if (b // chunks) % n_batch:
            raise ValueError(f"a grad-cache chunk of {b // chunks} rows (batch {b}, {chunks} chunks) does not "
                             f"split over {n_batch} batch ranks")
        labels = ground_labels if use_ground_labels else None
        if n_batch > 1:
            images, tokens = chunk_rows(images, group, chunks), chunk_rows(tokens, group, chunks)
            if labels is not None:
                labels = comm.all_gather(labels, group)
        m = b // chunks // n_batch  # this rank's rows of a chunk
        imgs, toks = images.split(m), tokens.split(m)
        is_fsdp = state.shards is not None
        if is_fsdp:
            fsdp.materialize(state)
        params = state.params
        trained = [p for p, f in zip(params, frozen) if not f]
        with pinned_mode(model, train=True), synced_batch_norm(model, group):
            # Pass 1: features only; running statistics chain chunk to chunk.
            with torch.no_grad():
                feats = [model(im, tk) for im, tk in zip(imgs, toks)]
            img_f = torch.cat([f[0] for f in feats])
            txt_f = torch.cat([f[1] for f in feats])
            scale = feats[0][2].clone().requires_grad_()  # a parameter's exp: equal in every chunk
            del feats
            if n_batch > 1:
                img_f, txt_f = global_rows(img_f, group, chunks), global_rows(txt_f, group, chunks)
            img_f.requires_grad_()
            txt_f.requires_grad_()

            # Pass 2: the whole batch's loss on the [B, D] features.
            per_item = clip_loss(img_f, txt_f, scale, labels, ignore=ignore, google_sup_loss=google_sup_loss)
            loss = per_item.mean()
            g_img, g_txt, g_scale = torch.autograd.grad(loss, [img_f, txt_f, scale])
            g_scale = g_scale / (chunks * n_batch)
            if n_batch > 1:
                g_img, g_txt = own_rows(g_img, group, chunks), own_rows(g_txt, group, chunks)
                if per_item.dim():
                    r = comm.group_rank(group)
                    per_item = per_item[r * b_local:(r + 1) * b_local]

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
        if is_fsdp or multi:
            grads = sync_grads(state, grads, group, replica)
        out = apply_gradients(state, grads, optimizer, frozen, loss=loss, per_item=per_item,
                              log_grad_norm=log_grad_norm)
        if is_fsdp:
            fsdp.release(state)
        return out

    return step_fn
