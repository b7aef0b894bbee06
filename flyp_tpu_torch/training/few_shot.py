"""Few-shot FLYP: k-shot binary-task fine-tuning with min-val-loss selection.

Counterpart of ``flyp_tpu/training/few_shot.py`` (the reference's
``flyp_loss_few_shot.py`` and its 50-restart driver ``few_shot.py``):

* one fixed, balanced 2k-sample train batch, assembled by scanning the
  contrastive CSV loader for k examples of each caption class;
* one fixed, balanced validation batch assembled the same way from the
  '*Val' evaluation dataset (k a label);
* ``epochs`` single-step updates on the train batch (``make_train_step``:
  B1 forward, B2 backward on the card); after each epoch a fresh zero-shot
  head scores the validation batch (B3), and the snapshot of the model with
  the least validation cross-entropy is kept: parameters and a
  ModifiedResNet's BatchNorm running statistics, as host copies;
* the kept snapshot is loaded back into the model, re-scored (both scores
  must reproduce) and evaluated on the '*Test' dataset.

The mean of the per-item loss is what the step differentiates, as in the
JAX package.  The protocol is a single process's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from flyp_tpu_torch.data.csv_data import get_csv_loader
from flyp_tpu_torch.data.registry import get_dataset_class
from flyp_tpu_torch.data.transforms import eval_transform
from flyp_tpu_torch.evaluation.classifier import Classifier
from flyp_tpu_torch.evaluation.evaluator import eval_single_batch, eval_single_dataset
from flyp_tpu_torch.parallel.multihost import process_count
from flyp_tpu_torch.tokenizer import shrink_context
from flyp_tpu_torch.training.flyp import build_zeroshot_head
from flyp_tpu_torch.training.schedules import warmup_cosine_lr
from flyp_tpu_torch.training.train_state import create_train_state, make_optimizer
from flyp_tpu_torch.training.train_step import make_train_step
from flyp_tpu_torch.utils.pipeline import host_cast_images, to_device

#: Full passes over the loader before the balanced-batch scan gives up.  Two
#: passes see every sample; the slack covers shuffle-dependent partial-batch
#: drops.  An unbounded scan would never end on a single-class CSV.
_MAX_SCAN_PASSES = 10


def _collect_balanced_contrastive_batch(loader, k: int):
    """Scan until k samples of each of the two caption classes are found:
    ``(images [2k, H, W, 3], tokens [2k, 77])``, the first caption's class
    first."""
    imgs0, toks0, imgs1, toks1 = [], [], [], []
    match = None
    for batch in _cycle(loader, max_passes=_MAX_SCAN_PASSES):
        for i in range(batch["tokens"].shape[0]):
            tok = batch["tokens"][i]
            if match is None:
                match = tok.copy()
            if np.array_equal(match, tok):
                if len(toks0) < k:
                    toks0.append(tok)
                    imgs0.append(batch["image"][i])
            elif len(toks1) < k:
                toks1.append(tok)
                imgs1.append(batch["image"][i])
        if len(toks0) == k and len(toks1) == k:
            break
    return np.stack(imgs0 + imgs1), np.stack(toks0 + toks1)


def _collect_balanced_label_batch(loader, k: int):
    """k a label from an evaluation loader: ``{"image", "label"}``."""
    imgs0, lab0, imgs1, lab1 = [], [], [], []
    match = None
    for batch in _cycle(loader, max_passes=_MAX_SCAN_PASSES):
        for i in range(len(batch["label"])):
            lab = int(batch["label"][i])
            if match is None:
                match = lab
            if lab == match:
                if len(lab0) < k:
                    lab0.append(lab)
                    imgs0.append(batch["image"][i])
            elif len(lab1) < k:
                lab1.append(lab)
                imgs1.append(batch["image"][i])
        if len(lab0) == k and len(lab1) == k:
            break
    return {"image": np.stack(imgs0 + imgs1), "label": np.asarray(lab0 + lab1, np.int64)}


def _cycle(loader, max_passes=None):
    epoch = 0
    while True:
        if max_passes is not None and epoch >= max_passes:
            raise RuntimeError(
                f"could not assemble a balanced few-shot batch after {max_passes} passes "
                "over the loader; the dataset must contain two classes with >= k examples each"
            )
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def _find_dataset(cfg, tag: str):
    for name in cfg.eval_datasets or []:
        if tag in name:
            return name
    raise AssertionError(f"please give {tag.lower()} data")


def _host_snapshot(model) -> dict:
    """The model's parameters and BatchNorm running statistics, copied to
    the host."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def _score(cfg, model, val_dataset, val_batch, k: int):
    head = build_zeroshot_head(cfg, model)
    clf = Classifier(model, head, batch_size=2 * k)
    val_acc, cnt_loss = eval_single_batch(clf, val_dataset, cfg, val_batch)
    return head, val_acc, cnt_loss


def flyp_few_shot(cfg, logger, model=None) -> Tuple[float, float]:
    """One k-shot run; returns ``(val accuracy, test top-1)``.  ``model``
    defaults to ``build_clip_model(cfg, device=cfg.device)``; the kept
    snapshot is left loaded in it."""
    if process_count() > 1:
        # One fixed 2k-sample batch on one device; the restart driver writes
        # a single stats file.
        raise NotImplementedError("few-shot is a single-process protocol; run it in one process")
    if model is None:
        from flyp_tpu_torch.models.factory import build_clip_model

        model = build_clip_model(cfg, device=cfg.device)
    device = model.device
    image_size = model.config.vision.image_size
    k = cfg.k

    # The fixed train batch from the contrastive CSV, scanned at batch size
    # k, replicated (the scan builds one host-side batch).
    scan_cfg = dataclasses.replace(cfg, batch_size=k)
    train_loader = get_csv_loader(scan_cfg, is_train=True, image_size=image_size, shard_by_process=False)
    ft_image, ft_text = _collect_balanced_contrastive_batch(train_loader, k)

    val_name = _find_dataset(cfg, "Val")
    logger.info(f"Evaluating on {val_name}")
    preprocess = eval_transform(image_size)
    val_dataset = get_dataset_class(val_name)(
        preprocess=preprocess, location=cfg.data_location, batch_size=k, num_workers=cfg.workers, k=cfg.k
    )
    val_batch = _collect_balanced_label_batch(val_dataset.test_loader, k)

    schedule = warmup_cosine_lr(cfg.lr, cfg.warmup_length, cfg.epochs * 1, cfg.min_lr)
    optimizer = make_optimizer(schedule, cfg.wd, cfg.adam_moment_dtype)
    state = create_train_state(model, optimizer)
    step_fn = make_train_step(model, optimizer)

    images = to_device(host_cast_images(ft_image, model.compute_dtype), device)
    # Exact context shrinking (causal tower + EOT pooling), as the trainer's loader does.
    tokens = to_device(torch.from_numpy(shrink_context(np.asarray(ft_text))), device)

    best = {"val": 0.0, "loss": 1e10, "vars": None}
    for epoch in range(-1, cfg.epochs):
        if epoch != -1:
            if ft_image.shape[0] != 2 * k:
                raise AssertionError("batch mismatch")
            state, _ = step_fn(state, images, tokens)

        _, val_acc, cnt_loss = _score(cfg, model, val_dataset, val_batch, k)
        logger.info(f"Epoch {epoch} results {val_acc}")
        if cnt_loss <= best["loss"]:
            # Running statistics move every step: the snapshot carries them,
            # or the re-score below would not reproduce.
            best = {"val": val_acc, "loss": cnt_loss, "vars": _host_snapshot(model)}

    # Load the best snapshot back and check that its scores reproduce.
    model.load_state_dict(best["vars"])
    head, val_acc, cnt_loss = _score(cfg, model, val_dataset, val_batch, k)
    if val_acc != best["val"]:
        raise AssertionError(f"max val not matching Max {best['val']}, new {val_acc}")
    if not abs(cnt_loss - best["loss"]) < 1e-6:
        raise AssertionError(f"min val not matching Max {best['loss']}, new {cnt_loss}")

    test_name = _find_dataset(cfg, "Test")
    logger.info(f"Evaluating on {test_name}")
    test_dataset = get_dataset_class(test_name)(
        preprocess=preprocess, location=cfg.data_location, batch_size=cfg.batch_size, num_workers=cfg.workers,
        k=cfg.k,
    )
    results = eval_single_dataset(Classifier(model, head, batch_size=cfg.batch_size), test_dataset, cfg)
    return val_acc, round(results["top1"], 4)


def few_shot_driver(cfg, logger, num_runs: int = 50, model_factory=None) -> dict:
    """``num_runs`` independent restarts, each on a fresh model
    (``model_factory()``, else ``build_clip_model``); the mean and standard
    deviation of the validation and test accuracies go to
    ``stats_final.txt`` in the log directory."""
    if cfg.k not in (4, 16, 32):
        raise AssertionError("please specify correct k")
    log_dir = cfg.log_dir or os.path.join("expt_logs", cfg.exp_name or "few_shot", cfg.run_key())
    os.makedirs(log_dir, exist_ok=True)

    val_accs, test_accs = [], []
    for run_iter in range(num_runs):
        logger.info(f"------------------ Running iteration {run_iter} -------------------")
        if model_factory is not None:
            model = model_factory()
        else:
            from flyp_tpu_torch.models.factory import build_clip_model

            model = build_clip_model(cfg, device=cfg.device)
        val_acc, test_acc = flyp_few_shot(cfg, logger, model=model)
        logger.info(f"Val {val_acc} {test_acc}")
        val_accs.append(val_acc)
        test_accs.append(test_acc)

    summary = {
        "Val": round(float(np.mean(val_accs)), 4),
        "Test": round(float(np.mean(test_accs)), 4),
        "ValDev": round(float(np.std(val_accs)), 4),
        "TestDev": round(float(np.std(test_accs)), 4),
    }
    with open(os.path.join(log_dir, "stats_final.txt"), "w") as f:
        for key, value in summary.items():
            f.write(f"{key}: {value}\n")
    return summary
