"""Evaluation harness: one loop per dataset with the dataset hooks.

Counterpart of ``flyp_tpu/evaluation/evaluator.py``:

* a dataset may define ``project_logits`` (ObjectNet's 113-class max-pool,
  the ImageNet sublists), ``project_labels``, a custom ``accuracy``
  (ObjectNet; it bypasses the per-class tallies), ``post_loop_metrics``
  (WILDS, VidRobust), OxfordPet's ``index_cat`` relabel, and
  ``excluded_indices`` (rows left out of the post-loop metrics);
* the metrics dict holds ``top1``, ``class_top1`` {class: [correct,
  total]}, and ``guidance_top1``/``guidance_f1`` for the curriculum's
  progress eval;
* ``evaluate`` fills ``train_stats`` with the key spellings and order the
  stats TSVs and the Avg-OOD aggregation read ("<name> Accuracy",
  "<name> Class {c} Accuracy", "<name> Class {c} Number", and the
  worst-group, F1 and pm0 values passed through).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from flyp_tpu_torch.evaluation import metrics as M
from flyp_tpu_torch.utils.pipeline import OneStepLag, lagged_device_method


def _log(logger, msg):
    if logger is not None:
        logger.info(msg)


def eval_single_dataset(
    classifier,
    dataset,
    cfg,
    progress_eval: bool = False,
    progress_num_classes: int = 181,
) -> Dict:
    """One pass over ``dataset.test_loader``; returns the metrics dict."""
    loader = dataset.test_loader

    collects = hasattr(dataset, "post_loop_metrics") or getattr(cfg, "self_data", False)
    all_labels, all_logits, all_metadata = [], [], []

    # OxfordPet's cat/dog projection.
    index_cat = getattr(dataset, "index_cat", None)
    index_dog_lbl, index_cat_lbl = 79, 66

    dict_class: Dict[int, list] = {}
    dict_guidance: Dict[int, list] = {}
    guid_labels: Dict[int, list] = {}
    guid_preds: Dict[int, list] = {}

    correct, n = 0.0, 0
    has_custom_acc = hasattr(dataset, "accuracy")

    dispatch, fetch = lagged_device_method(classifier, "predict_logits_device", "predict_logits")

    def _process(handle, batch):
        nonlocal correct, n
        labels = np.asarray(batch.get("label"))
        logits = fetch(handle)  # the host fetch

        project_logits = getattr(dataset, "project_logits", None)
        if project_logits is not None:
            logits = project_logits(logits)
        if hasattr(dataset, "project_labels"):
            labels = np.asarray(dataset.project_labels(labels))
        preds = logits.argmax(axis=1)

        if index_cat is not None:
            labels = np.where(np.isin(labels, list(index_cat)), index_cat_lbl, index_dog_lbl)

        if has_custom_acc:
            acc1, num_total = dataset.accuracy(logits, labels, batch.get("path"), cfg)
            correct += acc1
            n += num_total
        else:
            correct += float((preds == labels).sum())
            n += labels.shape[0]
            M.per_class_tally(preds, labels, dict_class)

            if progress_eval and "guidance" in batch:
                guidance = np.asarray(batch["guidance"])
                for g in np.unique(guidance):
                    sel = guidance == g
                    rec = dict_guidance.setdefault(int(g), [0, 0])
                    rec[0] += int((preds[sel] == labels[sel]).sum())
                    rec[1] += int(sel.sum())
                    guid_labels.setdefault(int(g), []).append(labels[sel])
                    guid_preds.setdefault(int(g), []).append(preds[sel])

        if collects:
            all_labels.append(labels)
            all_logits.append(logits)
            meta = batch.get("metadata", batch.get("path"))
            if meta is not None:
                all_metadata.extend(list(meta))

    # One batch in flight: batch i+1's forward is launched before batch i's
    # logits are fetched, so the copy to the host and the metric work here
    # overlap the card's work.
    lag = OneStepLag()
    for batch in loader:
        prev = lag.push((dispatch(batch["image"]), batch))
        if prev is not None:
            _process(*prev)
    prev = lag.flush()
    if prev is not None:
        _process(*prev)

    results: Dict = {}
    if collects:
        labels_cat = np.concatenate(all_labels)
        logits_cat = np.concatenate(all_logits)
        excluded = getattr(dataset, "excluded_indices", None)
        if excluded is not None:
            mask = np.ones(labels_cat.shape[0], dtype=bool)
            mask[np.asarray(excluded)] = False
            labels_cat, logits_cat = labels_cat[mask], logits_cat[mask]
        # --self_data takes precedence over post_loop_metrics: self-data runs
        # score the plain argmax accuracy even on datasets with the hook.
        if hasattr(dataset, "post_loop_metrics") and not getattr(cfg, "self_data", False):
            results = dict(dataset.post_loop_metrics(labels_cat, logits_cat, all_metadata, cfg))
        else:
            results = {"acc": float((logits_cat.argmax(axis=1) == labels_cat).mean())}
        if "acc" in results:
            results["top1"] = results["acc"]

    if "top1" not in results:
        results["top1"] = correct / max(n, 1)
    if dict_class:
        results["class_top1"] = dict_class
    if dict_guidance:
        results["guidance_top1"] = dict_guidance
        results["guidance_f1"] = {
            g: M.macro_f1(np.concatenate(guid_preds[g]), np.concatenate(guid_labels[g]), progress_num_classes)
            for g in guid_labels
        }
    return results


def eval_single_batch(classifier, dataset, cfg, batch) -> tuple:
    """Top-1 and CE loss on one fixed batch (the few-shot model-selection
    criterion)."""
    images = batch["image"]
    labels = np.asarray(batch["label"])
    logits = classifier.predict_logits(images)

    project_logits = getattr(dataset, "project_logits", None)
    if project_logits is not None:
        logits = project_logits(logits)
    if hasattr(dataset, "project_labels"):
        labels = np.asarray(dataset.project_labels(labels))

    shifted = logits - logits.max(axis=1, keepdims=True)
    log_probs = shifted - np.log(np.exp(shifted).sum(axis=1, keepdims=True))
    ce_loss = float(-log_probs[np.arange(len(labels)), labels].mean())
    top1 = float((logits.argmax(axis=1) == labels).mean())
    return top1, ce_loss


def process_train_stat(results: Dict, train_stats: Dict, logger=None, dataset_name: str = "") -> None:
    """Pass the worst-group, F1 and pm0 metrics through to ``train_stats``."""
    for key, val in results.items():
        if ("worst" in key or "f1" in key.lower() or "pm0" in key) and "guidance" not in key.lower():
            _log(logger, f"{dataset_name} {key}: {val:.4f}")
            train_stats[dataset_name + key] = round(float(val), 4)


def evaluate(
    classifier,
    cfg,
    train_stats: Optional[Dict] = None,
    logger=None,
    progress_eval: bool = False,
    eval_batch_loader=None,
) -> Optional[Dict]:
    """Every dataset of ``cfg.eval_datasets`` (or, with ``progress_eval``,
    the curriculum's guidance CSV), into ``train_stats``."""
    if cfg.eval_datasets is None:
        return None
    train_stats = train_stats if train_stats is not None else {}

    if progress_eval:
        assert eval_batch_loader is not None, "progress eval needs the curriculum loader"
        results = eval_single_dataset(classifier, eval_batch_loader, cfg, progress_eval=True)
        for g, f1 in sorted(results.get("guidance_f1", {}).items()):
            _log(logger, f"Guidance F1: {g} {f1:.4f}")
            train_stats[f"Guidance {g} F1"] = round(f1, 4)
        pairs = sorted(
            ((g, rec[0] / rec[1], rec[1]) for g, rec in results.get("guidance_top1", {}).items()),
            key=lambda x: x[1],
        )
        for g, acc, num in pairs:
            _log(logger, f"Guidance Top-1 accuracy: {g} {acc:.4f}")
            train_stats[f"Guidance {g} Accuracy"] = round(acc, 4)
            train_stats[f"Guidance {g} Number"] = num
        process_train_stat(results, train_stats, logger)
        return train_stats

    from flyp_tpu_torch.data.registry import get_dataset_class
    from flyp_tpu_torch.data.transforms import eval_transform

    # Eval preprocessing at the image tower's resolution.
    image_size = classifier.model.config.vision.image_size
    preprocess = eval_transform(image_size)

    for dataset_name in cfg.eval_datasets:
        _log(logger, f"Evaluating on {dataset_name}")
        if getattr(cfg, "self_data", False):
            # --self_data evaluates the ft_data_test CSV, not the registry's
            # dataset; the name only labels the stats keys, and the plain
            # argmax accuracy applies (no dataset hooks).
            from flyp_tpu_torch.data.csv_data import get_csv_loader

            dataset = get_csv_loader(cfg, is_train=False, image_size=image_size)
        else:
            dataset_cls = get_dataset_class(dataset_name)
            dataset = dataset_cls(
                preprocess=preprocess, location=cfg.data_location, batch_size=cfg.batch_size, num_workers=cfg.workers
            )
        results = eval_single_dataset(classifier, dataset, cfg)

        if "top1" in results:
            _log(logger, f"{dataset_name} Top-1 accuracy: {results['top1']:.4f}")
            train_stats[dataset_name + " Accuracy"] = round(results["top1"], 4)
        # Ascending accuracy; ties keep the order classes were first seen.
        for cls, (c, total) in sorted(
            results.get("class_top1", {}).items(), key=lambda kv: kv[1][0] / kv[1][1]
        ):
            train_stats[dataset_name + f" Class {cls} Accuracy"] = round(c / total, 4)
            train_stats[dataset_name + f" Class {cls} Number"] = total
        process_train_stat(results, train_stats, logger, dataset_name)

    return train_stats
