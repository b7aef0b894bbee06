"""ImageNet family: base train/val sets, k-shot subsets and the class-sublist
machinery.

Counterpart of ``flyp_tpu/data/datasets/imagenet.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from flyp_tpu_torch.data.classnames import get_classnames
from flyp_tpu_torch.data.datasets.base import ImageFolderDataset, VisionDataset


def project_logits(logits: np.ndarray, class_sublist_mask: Sequence[bool]) -> np.ndarray:
    """Keep only the sublist's columns when the head is 1000 wide."""
    mask = np.asarray(class_sublist_mask)
    if logits.shape[1] > int(mask.sum()):
        return logits[:, mask]
    return logits


class ImageNet(VisionDataset):
    def _resolve_classnames(self, classnames):
        self.classnames = get_classnames(classnames) if isinstance(classnames, str) else list(classnames)

    def populate_train(self):
        traindir = os.path.join(self.location, "ILSVRC2012", "train")
        self.train_dataset = ImageFolderDataset.from_root(traindir, self.train_preprocess)
        self.train_loader = self.make_train_loader(self.train_dataset, indices=self.get_train_indices())

    def get_train_indices(self) -> Optional[Sequence[int]]:
        return None

    def get_test_path(self) -> str:
        # ``val_dirs`` first, then ``val``.
        test_path = os.path.join(self.location, "ILSVRC2012", "val_dirs")
        if not os.path.exists(test_path):
            test_path = os.path.join(self.location, "ILSVRC2012", "val")
        return test_path

    def get_test_dataset(self):
        return ImageFolderDataset.from_root(self.get_test_path(), self.preprocess)

    def name(self):
        return "imagenet"


class ImageNetTrain(ImageNet):
    def populate_test(self):
        self.test_dataset = None
        self.test_loader = None


class ImageNetK(ImageNet):
    """k images per class, a fixed subset of the train split."""

    def k(self) -> int:
        raise NotImplementedError

    def get_train_indices(self):
        labels = np.array([l for _, l in self.train_dataset.samples])
        rng = np.random.default_rng(self.seed)
        keep: List[int] = []
        for c in range(1000):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            keep.extend(idx[: self.k()].tolist())
        return sorted(keep)


class ImageNetSubsample(ImageNet):
    """OOD sets covering a sublist of the 1000 classes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        class_sublist, self.class_sublist_mask = self.get_class_sublist_and_mask()
        self.classnames = [self.classnames[i] for i in class_sublist]

    def get_class_sublist_and_mask(self):
        raise NotImplementedError

    def populate_train(self):
        self.train_dataset = None
        self.train_loader = None

    def project_logits(self, logits):
        return project_logits(logits, self.class_sublist_mask)


class ImageNetSubsampleValClasses(ImageNet):
    """The standard val set restricted to the sublist's classes, 50 images
    each."""

    def get_class_sublist_and_mask(self):
        raise NotImplementedError

    def populate_train(self):
        self.train_dataset = None
        self.train_loader = None

    def get_test_indices(self):
        self.class_sublist, self.class_sublist_mask = self.get_class_sublist_and_mask()
        return sorted(i for x in self.class_sublist for i in range(x * 50, (x + 1) * 50))

    def project_labels(self, labels):
        return np.asarray([self.class_sublist.index(int(l)) for l in labels], dtype=np.int64)

    def project_logits(self, logits):
        return project_logits(logits, self.class_sublist_mask)


class ImageNetKShot(ImageNetK):
    """k-shot ImageNet with k passed at construction."""

    def __init__(self, preprocess=None, *args, k=None, **kwargs):
        self._k = k
        super().__init__(preprocess, *args, **kwargs)

    def k(self) -> int:
        assert self._k is not None, "ImageNetKShot requires k"
        return self._k


def _make_k_class(k: int):
    return type(f"ImageNet{k}", (ImageNetK,), {"k": lambda self, num=k: num})


IMAGENET_K_CLASSES = {f"ImageNet{k}": _make_k_class(k) for k in (1, 2, 4, 8, 16, 25, 32, 50, 64, 128, 600)}
