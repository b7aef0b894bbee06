"""Diagonal Fisher information of the zero-shot classifier.

Counterpart of ``flyp_tpu/training/fisher.py`` (the reference's
``fisher.py``): labels are sampled from the model's own softmax, and the
squares of each example's gradient of its log-likelihood are summed per
parameter, then averaged over the train set and pickled.

Each example's gradient is one forward and backward at batch size 1, the
reference's own protocol.  (The JAX package vectorises that loop with
``jax.vmap(jax.grad)``; the port's kernels are autograd functions bound
through ctypes, which ``torch.func.vmap`` cannot batch.)  On a ViT the
image tower runs in eval mode: the sampling logits come from one
full-batch forward (B3), and each example's backward runs B1 then B2 a
block.  On a ModifiedResNet the reference runs the model in training mode,
so BatchNorm normalises each single-example pass by its own statistics,
both for the sampling logits and for the gradient; the running statistics
are read and never written.  Parameters the loss does not reach (the text
tower, ``logit_scale``) get zeros, as in the JAX tree.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from flyp_tpu_torch.data.registry import get_dataset_class
from flyp_tpu_torch.data.transforms import train_transform
from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.models.resnet import running_stats_frozen
from flyp_tpu_torch.parallel.multihost import is_primary
from flyp_tpu_torch.utils.pipeline import host_cast_images, to_device


@contextlib.contextmanager
def _fisher_mode(model: CLIPModel, grad: bool):
    """The image tower's mode (eval on a ViT; training with frozen running
    statistics on a ModifiedResNet) and, with ``grad``, every parameter
    requiring grad; the model's flags are restored afterwards."""
    flags = [p.requires_grad for p in model.parameters()]
    train = not model.config.vision.is_vit
    try:
        with pinned_mode(model, train=False), pinned_mode(model.visual, train=train), running_stats_frozen(model):
            if grad:
                model.requires_grad_(True)
            yield
    finally:
        for p, f in zip(model.parameters(), flags):
            p.requires_grad_(f)


def make_fisher_step(model: CLIPModel, head, label_smoothing: float = 0.0, seed: int = 0):
    """Returns ``step(images, labels=None) -> (sq_sum, n)``: ``sq_sum`` maps
    every parameter name to the fp32 sum over the batch of the squares of
    that example's gradient, ``n`` the batch size.  ``images [B, H, W, 3]``
    lie on the model's device.  Without ``labels`` they are drawn from the
    softmax of the head's logits with a ``torch.Generator`` on the model's
    device, seeded with ``seed`` and carried from call to call."""
    generator = torch.Generator(device=model.device).manual_seed(int(seed))
    names = [n for n, _ in model.named_parameters()]
    is_vit = model.config.vision.is_vit

    def logits_of(images):
        return head(model.encode_image(images)).float()

    def step(images: torch.Tensor, labels: Optional[torch.Tensor] = None):
        n = images.shape[0]
        if labels is None:
            with torch.no_grad(), _fisher_mode(model, grad=False):
                if is_vit:
                    logits = logits_of(images)
                else:
                    # One example a pass, the same per-example statistics the
                    # gradient below differentiates.
                    logits = torch.cat([logits_of(images[i:i + 1]) for i in range(n)])
            labels = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]
        params = list(model.parameters())
        sq_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        with _fisher_mode(model, grad=True):
            for i in range(n):
                logits = logits_of(images[i:i + 1])[0]
                num_classes = logits.shape[-1]
                onehot = torch.nn.functional.one_hot(labels[i].long(), num_classes).float()
                if label_smoothing > 0:
                    onehot = onehot * (1 - label_smoothing) + label_smoothing / num_classes
                loss = -torch.sum(onehot * torch.log_softmax(logits, dim=-1))
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                present = [(a, g) for a, g in zip(sq_sum, grads) if g is not None]
                torch._foreach_addcmul_([a for a, _ in present], [g.float() for _, g in present],
                                        [g.float() for _, g in present])
        return dict(zip(names, sq_sum)), n

    return step


def nest(flat: Dict[str, np.ndarray]) -> dict:
    """``{"a.b.c": x}`` -> ``{"a": {"b": {"c": x}}}``: the port's parameter
    names as the JAX package's parameter tree."""
    out: dict = {}
    for name, value in flat.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def compute_fisher(cfg, logger=None, model=None, head=None, max_batches: Optional[int] = None) -> dict:
    """Accumulate the diagonal Fisher over the train set and pickle it to
    ``cfg.fisher``: the JAX package's layout, a nested dict of float32
    numpy arrays shaped as the parameter tree (``from_jax_params`` flattens
    it back).  Returns that dict.  Every process estimates it on the whole
    train set; rank 0 alone writes."""
    if cfg.train_dataset is None:
        raise AssertionError("Please provide a training dataset.")
    if cfg.fisher is None:
        raise AssertionError("Please provide a path to save the Fisher to through --fisher.")
    (save_path,) = cfg.fisher if isinstance(cfg.fisher, (list, tuple)) else (cfg.fisher,)
    save_path = os.path.expanduser(save_path)

    if model is None:
        from flyp_tpu_torch.models.factory import build_clip_model

        model = build_clip_model(cfg, device=cfg.device)
    if head is None:
        from flyp_tpu_torch.training.flyp import build_zeroshot_head

        head = build_zeroshot_head(cfg, model)

    image_size = model.config.vision.image_size
    dataset = get_dataset_class(cfg.train_dataset)(
        preprocess=train_transform(image_size), location=cfg.data_location,
        batch_size=cfg.batch_size, num_workers=cfg.workers,
    )
    # A whole-dataset statistic with no reduction across processes: every
    # process reads the whole train set.
    if getattr(dataset.train_loader, "shard_by_process", False):
        dataset.train_loader.shard_by_process = False

    fisher_step = make_fisher_step(model, head, cfg.ls, seed=cfg.seed)
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in model.named_parameters()}
    count = 0
    for epoch in range(cfg.epochs):
        dataset.train_loader.set_epoch(epoch)
        for i, batch in enumerate(dataset.train_loader):
            if max_batches is not None and i >= max_batches:
                break
            images = to_device(host_cast_images(batch["image"], model.compute_dtype), model.device)
            sq_sum, n = fisher_step(images)
            for name, s in sq_sum.items():
                acc[name].add_(s)
            count += n

    fisher = nest({name: (a / max(count, 1)).cpu().numpy() for name, a in acc.items()})
    if is_primary():
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(fisher, f)
        if logger is not None:
            logger.info(f"Saved Fisher ({count} samples) to {save_path}")
    return fisher
