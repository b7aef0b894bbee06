"""ImageNet distribution-shift suites: V2, R, A and Sketch.

Counterpart of ``flyp_tpu/data/datasets/imagenet_shifts.py``.
"""

from __future__ import annotations

import os

from flyp_tpu_torch.data.classnames import IMAGENET_A_SUBLIST, IMAGENET_R_SUBLIST
from flyp_tpu_torch.data.datasets.base import IMG_EXTENSIONS, ImageFolderDataset
from flyp_tpu_torch.data.datasets.imagenet import ImageNet, ImageNetSubsample, ImageNetSubsampleValClasses

_R_MASK = [(i in set(IMAGENET_R_SUBLIST)) for i in range(1000)]
_A_MASK = [(i in set(IMAGENET_A_SUBLIST)) for i in range(1000)]


class _NumericFolderDataset(ImageFolderDataset):
    """ImageNet-V2's layout: class folders named by their integer label
    0..999, so the label is the folder's name."""

    @classmethod
    def from_root(cls, root, transform, **kw):
        samples = []
        for d in sorted(os.scandir(root), key=lambda e: e.name):
            # Folders that are not numbers and files that are not images
            # (checksums, .DS_Store) are left out.
            if d.is_dir() and d.name.isdigit():
                label = int(d.name)
                for f in sorted(os.scandir(d.path), key=lambda e: e.name):
                    if f.is_file() and f.name.lower().endswith(IMG_EXTENSIONS):
                        samples.append((f.path, label))
        return cls(samples, transform, **kw)


class ImageNetV2(ImageNet):
    def populate_train(self):
        self.train_dataset = None
        self.train_loader = None

    def get_test_dataset(self):
        root = os.path.join(self.location, "ImageNetV2-matched-frequency")
        return _NumericFolderDataset.from_root(root, self.preprocess)


class ImageNetSketch(ImageNet):
    def populate_train(self):
        self.train_dataset = None
        self.train_loader = None

    def get_test_path(self):
        return os.path.join(self.location, "sketch")


class ImageNetRValClasses(ImageNetSubsampleValClasses):
    def get_class_sublist_and_mask(self):
        return IMAGENET_R_SUBLIST, _R_MASK


class ImageNetR(ImageNetSubsample):
    def get_class_sublist_and_mask(self):
        return IMAGENET_R_SUBLIST, _R_MASK

    def get_test_path(self):
        return os.path.join(self.location, "imagenet-r")


class ImageNetAValClasses(ImageNetSubsampleValClasses):
    def get_class_sublist_and_mask(self):
        return IMAGENET_A_SUBLIST, _A_MASK


class ImageNetA(ImageNetSubsample):
    def get_class_sublist_and_mask(self):
        return IMAGENET_A_SUBLIST, _A_MASK

    def get_test_path(self):
        return os.path.join(self.location, "imagenet-a")
