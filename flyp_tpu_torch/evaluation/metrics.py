"""Evaluation metrics (host-side numpy).

Counterpart of ``flyp_tpu/evaluation/metrics.py``.  ``macro_f1`` is written
out in numpy (the JAX package calls scikit-learn, which the machine with the
card does not have) with the same semantics: the average runs over the
classes present in the labels or the predictions, and a class with no true
positive scores 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, ks: Sequence[int] = (1,)) -> list:
    """Counts (not rates) of top-k correct."""
    order = np.argsort(-logits, axis=1)
    return [float((order[:, :k] == labels[:, None]).any(axis=1).sum()) for k in ks]


def macro_f1(preds: np.ndarray, labels: np.ndarray, num_classes: Optional[int] = None) -> float:
    """Macro F1 over the union of the class ids present in ``labels`` and
    ``preds`` (torcheval's ``multiclass_f1_score(average='macro')`` masks
    classes absent from both; without ``num_classes`` this is also
    scikit-learn's default label set).  Per class ``2 tp / (2 tp + fp + fn)``."""
    del num_classes  # the same label set either way; kept for the JAX signature
    preds, labels = np.asarray(preds), np.asarray(labels)
    present = np.union1d(np.unique(labels), np.unique(preds))
    scores = []
    for c in present:
        tp = float(np.sum((preds == c) & (labels == c)))
        fp = float(np.sum((preds == c) & (labels != c)))
        fn = float(np.sum((preds != c) & (labels == c)))
        scores.append(2.0 * tp / (2.0 * tp + fp + fn) if tp > 0 else 0.0)
    return float(np.mean(scores)) if scores else 0.0


def per_class_tally(preds: np.ndarray, labels: np.ndarray, tally: Dict[int, list]) -> Dict[int, list]:
    """Accumulate ``{class: [correct, total]}``; classes enter ``tally`` in
    the order they are first seen (sorted within a batch)."""
    for cls in np.unique(labels):
        sel = labels == cls
        rec = tally.setdefault(int(cls), [0, 0])
        rec[0] += int((preds[sel] == cls).sum())
        rec[1] += int(sel.sum())
    return tally
