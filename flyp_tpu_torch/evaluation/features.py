"""Image-tower feature extraction and its on-disk cache.

Counterpart of ``flyp_tpu/evaluation/features.py``: a dataset's images are
encoded once through the (frozen) image tower, and ``features``,
``labels`` (and ``paths`` where asked) are cached in one ``.npz`` per
dataset class and split, then served as an indexable dataset.  The cache
is valid only while the encoder is frozen: the per-epoch evaluation
re-encodes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from flyp_tpu_torch.parallel import multihost
from flyp_tpu_torch.utils.pipeline import OneStepLag, lagged_device_method


def _cache_path(cache_dir: str, dataset, split: str) -> str:
    return os.path.join(cache_dir, type(dataset).__name__, split, "features.npz")


def extract_loader_features(classifier, loader, with_paths: bool = False) -> Dict[str, np.ndarray]:
    """One encoding pass over a loader: ``{'features', 'labels'[, 'paths']}``."""
    feats, labels, paths = [], [], []
    dispatch, fetch = lagged_device_method(classifier, "features_device", "features")
    lag = OneStepLag()  # batch i's fetch overlaps batch i+1's encoding
    for batch in loader:
        prev = lag.push(dispatch(batch["image"]))
        if prev is not None:
            feats.append(fetch(prev))
        labels.append(np.asarray(batch["label"]))
        if with_paths and "path" in batch:
            paths.extend(list(batch["path"]))
    prev = lag.flush()
    if prev is not None:
        feats.append(fetch(prev))
    out = {"features": np.concatenate(feats), "labels": np.concatenate(labels)}
    if paths:
        out["paths"] = np.asarray(paths)
    return out


def get_features(
    classifier,
    dataset,
    split: str = "train",
    cache_dir: Optional[str] = None,
    with_paths: bool = False,
) -> Dict[str, np.ndarray]:
    """Cached features of ``dataset.{train,test}_loader``: a warm cache is
    served without touching the encoder; a miss encodes and fills the cache
    when ``cache_dir`` is set."""
    cache = _cache_path(cache_dir, dataset, split) if cache_dir else None
    if cache and os.path.exists(cache):
        with np.load(cache, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    loader = dataset.train_loader if split == "train" else dataset.test_loader
    out = extract_loader_features(classifier, loader, with_paths=with_paths)
    if cache and multihost.is_primary():
        # Every process reaches this miss with the same key: only the
        # primary writes, to a temporary file renamed into place, so a
        # concurrent reader never sees a torn .npz.
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        tmp = cache + f".{os.getpid()}.tmp.npz"  # np.savez appends .npz to names without it
        np.savez(tmp, **out)
        os.replace(tmp, cache)
    return out


class FeatureDataset:
    """Indexable (feature, label) view."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self.features = data["features"]
        self.labels = data["labels"]

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {"features": self.features[idx], "labels": self.labels[idx]}
