"""Cross-entropy ablation: classify with a language-derived head sampled
fresh each step.

Counterpart of ``flyp_tpu/training/ce_ablation.py`` (the reference's
``ce_ablation.py``): every class x template prompt is tokenised once (the
context shrunk once over the whole pool); each step samples one template a
class from ``np.random.default_rng(cfg.seed)`` (the JAX package's picks),
encodes the C class prompts and the image batch, and takes the
(label-smoothed) cross-entropy of ``scale * img_f @ txt_f.T`` against the
integer labels, then an AdamW update.

The towers run as the JAX step runs them: the text tower in eval mode, the
image tower in eval mode on a ViT and in training mode (batch statistics,
running statistics updated) on a ModifiedResNet.  So on a ViT every block
runs the inference kernel forward (B3) and, in the backward, the training
forward again (B1) and its backward (B2).

Several processes (``cli/main.py --ce_ablation`` under torchrun) train one
replicated model on the mesh of ``--mesh_data``/``--mesh_model``: each rank
loads its rows of the global batch, backpropagates its share of the global
mean, and the gradients are summed over the batch axes; a ModifiedResNet's
BatchNorm normalises with the global batch's statistics there.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from flyp_tpu_torch.data.registry import get_classnames_for, get_dataset_class
from flyp_tpu_torch.data.transforms import train_transform
from flyp_tpu_torch.evaluation.classifier import Classifier
from flyp_tpu_torch.evaluation.evaluator import evaluate
from flyp_tpu_torch.models.clip import CLIPModel, l2_normalize
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.models.resnet import synced_batch_norm
from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh_for_batch
from flyp_tpu_torch.parallel.multihost import (configure_input_sharding, is_primary, local_batch_size,
                                               process_count, reset_input_sharding)
from flyp_tpu_torch.templates import get_template
from flyp_tpu_torch.tokenizer import shrink_context, tokenize
from flyp_tpu_torch.training.flyp import _avg_ood_acc, _saves_committed, _write_tsv, build_zeroshot_head
from flyp_tpu_torch.training.schedules import make_scheduler
from flyp_tpu_torch.training.train_state import AdamW, TrainState, create_train_state, make_optimizer
from flyp_tpu_torch.training.train_step import batch_groups
from flyp_tpu_torch.utils.checkpoint import save_checkpoint
from flyp_tpu_torch.utils.logging import get_logger
from flyp_tpu_torch.utils.metrics_sink import MetricsSink
from flyp_tpu_torch.utils.pipeline import OneStepLag, host_cast_images, to_device


def ce_loss(model: CLIPModel, images: torch.Tensor, labels: torch.Tensor, class_texts: torch.Tensor,
            label_smoothing: float = 0.0, rows: int = 0) -> torch.Tensor:
    """The ablation's objective: the mean over ``rows`` (default this
    batch's) of the per-image cross-entropy.  Runs the towers in the modes
    of the module docstring, whatever the model's."""
    with pinned_mode(model, train=False), pinned_mode(model.visual, train=not model.config.vision.is_vit):
        img_f = l2_normalize(model.encode_image(images))
        txt_f = l2_normalize(model.encode_text(class_texts))
    # fp32 logits: JAX promotes the bf16 features against the fp32 scale.
    logits = torch.exp(model.logit_scale).float() * img_f.float() @ txt_f.float().T
    num_classes = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num_classes
    per_row = -torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1)
    return per_row.sum() / (rows or per_row.shape[0])


def make_ce_train_step(model: CLIPModel, optimizer: AdamW, mesh=None, label_smoothing: float = 0.0) -> Callable:
    """``step(state, images, labels, class_texts) -> (state, metrics)``:
    ``images [B, H, W, 3]``, ``labels [B]`` and the sampled prompts ``[C,
    ctx]`` on the model's device; ``metrics`` holds the ``loss`` and the
    ``learning_rate`` used, on the device.  The state is updated in place.

    ``mesh``: the step of one rank of a multi-rank mesh, the state
    replicated on it; ``images`` and ``labels`` are this rank's rows of the
    global batch and ``loss`` is the global batch's."""
    from flyp_tpu_torch.parallel import comm

    multi = mesh is not None and mesh.size > 1
    n_batch, group, _ = batch_groups(mesh if multi else None)

    def step(state: TrainState, images, labels, class_texts):
        if state.model is not model:
            raise ValueError("the state holds another model than the one this step was built for")
        params = state.params
        rows = images.shape[0] * n_batch
        with synced_batch_norm(model, group):
            objective = ce_loss(model, images, labels, class_texts, label_smoothing, rows=rows)
            grads = list(torch.autograd.grad(objective, params, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        loss = objective.detach()
        if multi:
            grads = comm.all_reduce_flat(grads, group)
            loss = comm.all_reduce_(loss.clone(), group)
        lr = optimizer.update(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss, "learning_rate": lr}

    return step


def _build_mesh(cfg):
    """The JAX ablation's mesh (``--mesh_data``, ``--mesh_model``), which
    must cover every rank."""
    mesh = create_mesh_for_batch(MeshConfig(cfg.mesh_data, cfg.mesh_model), cfg.batch_size)
    if mesh.size != process_count():
        raise ValueError(f"the mesh {mesh} for batch_size {cfg.batch_size} covers {mesh.size} of "
                         f"{process_count()} ranks; launch {mesh.size} processes or change the batch or the mesh")
    return mesh


def ce_ablation(cfg, logger=None, model=None, print_every: int = 100):
    """Run the ablation; returns the last checkpoint path (if saving).
    ``model`` defaults to ``build_clip_model(cfg, device=cfg.device)``; with
    several ranks every one calls it."""
    log_dir = cfg.log_dir or os.path.join("expt_logs", cfg.exp_name or "ce", cfg.run_key())
    os.makedirs(log_dir, exist_ok=True)
    logger = logger or get_logger(log_dir)
    primary = is_primary()
    mesh = _build_mesh(cfg)
    if model is None:
        from flyp_tpu_torch.models.factory import build_clip_model

        model = build_clip_model(cfg, device=cfg.device)
    # The loaders shard rows by the mesh's input grid; unpinned on every way out.
    configure_input_sharding(mesh)
    sink = MetricsSink(log_dir, enabled=not cfg.debug and primary)
    try:
        return _train(cfg, logger, model, print_every, log_dir, sink, primary, mesh)
    finally:
        sink.close()
        reset_input_sharding()


def _train(cfg, logger, model, print_every, log_dir, sink, primary, mesh):
    device = model.device
    image_size = model.config.vision.image_size
    template = get_template(cfg.template)
    classnames = get_classnames_for(cfg.train_dataset, cfg)

    # Every class x template prompt, [C, T, 77], the context shrunk once over
    # the whole pool (exact: causal tower + EOT pooling), so every step's
    # sampled [C, ctx] batch has one shape.
    all_texts = np.stack([tokenize([t(c) for t in template]) for c in classnames])
    C, T, ctx = all_texts.shape
    all_texts = shrink_context(all_texts.reshape(C * T, ctx)).reshape(C, T, -1)

    local_bs = local_batch_size(cfg.batch_size)
    dataset = get_dataset_class(cfg.train_dataset)(
        preprocess=train_transform(image_size), location=cfg.data_location,
        batch_size=local_bs, num_workers=cfg.workers,
    )
    train_loader = dataset.train_loader
    num_batches = len(train_loader)

    schedule = make_scheduler(cfg.scheduler, cfg.lr, cfg.warmup_length, cfg.epochs, num_batches, cfg.min_lr)
    optimizer = make_optimizer(schedule, cfg.wd, cfg.adam_moment_dtype)
    state = create_train_state(model, optimizer)
    multi = mesh.size > 1
    state.mesh = mesh  # replicated on every rank
    step_fn = make_ce_train_step(model, optimizer, mesh=mesh if multi else None, label_smoothing=cfg.ls)

    rng = np.random.default_rng(cfg.seed)
    stats = []
    model_path = None
    for epoch in range(cfg.epochs):
        logger.info(f"Epoch : {epoch}")
        epoch_stats = {"epoch": epoch}
        id_ce_loss_sum = 0.0
        train_loader.set_epoch(epoch)

        # Step i's metrics are fetched after step i+1 is launched.
        lag = OneStepLag()

        def drain_metrics(pend):
            nonlocal id_ce_loss_sum
            j, m = pend
            loss_val, lr = torch.stack([m["loss"].float(), m["learning_rate"].float()]).cpu().tolist()
            id_ce_loss_sum += loss_val
            sink.log({"Epoch": epoch, "ID CE Loss": loss_val, "Learning Rate": lr})
            if j % print_every == 0:
                logger.info(f"Train Epoch: {epoch} [{100 * j / num_batches:.0f}% {j}/{num_batches}]\t"
                            f"ID FLYP Loss: {loss_val:.4f}")

        for i, batch in enumerate(train_loader):
            if cfg.test:
                break
            # One template a class a step; drawn before the ragged check, as JAX draws.
            s = rng.integers(0, all_texts.shape[1], size=all_texts.shape[0])
            current_texts = all_texts[np.arange(all_texts.shape[0]), s]
            if batch["image"].shape[0] != local_bs:
                continue  # a ragged tail is dropped
            images = to_device(host_cast_images(batch["image"], model.compute_dtype), device)
            labels = to_device(torch.as_tensor(np.asarray(batch["label"], np.int64)), device)
            texts = to_device(torch.from_numpy(np.ascontiguousarray(current_texts)), device)
            state, metrics = step_fn(state, images, labels, texts)
            prev = lag.push((i, metrics))
            if prev is not None:
                drain_metrics(prev)

        prev = lag.flush()
        if prev is not None:
            drain_metrics(prev)

        id_ce_loss_avg = id_ce_loss_sum / max(num_batches, 1)
        head = build_zeroshot_head(cfg, model)
        evaluate(Classifier(model, head, batch_size=cfg.batch_size), cfg, epoch_stats, logger)

        if cfg.save is not None:
            model_path = os.path.join(cfg.save, f"checkpoint_{epoch}")
            os.makedirs(cfg.save, exist_ok=True)
            # Collective: every rank calls it, rank 0 writes.
            save_checkpoint(model_path, state)
            _saves_committed()
            if primary:
                logger.info("Saving model to " + str(model_path))

        ood_acc = _avg_ood_acc(epoch_stats)
        epoch_stats["Avg OOD Acc"] = round(ood_acc, 4)
        logger.info(f"Avg OOD Acc : {ood_acc:.4f}")
        epoch_stats["Avg ID FLYP Loss"] = round(id_ce_loss_avg, 4)
        stats.append({k: v for k, v in epoch_stats.items() if " Class" not in k})
        if primary:
            _write_tsv(os.path.join(log_dir, "stats.tsv"), range(len(stats)), stats)
    return model_path
