"""Dataset bases: directory scanning and dict-batch loaders.

Counterpart of ``flyp_tpu/data/datasets/base.py``.  Batches are dicts with
``image`` (NHWC float32), ``label`` and ``path``; datasets may add
``metadata``.  Pillow is imported where an image is opened, so the package
imports without it.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from flyp_tpu_torch.data.loader import DataLoader
from flyp_tpu_torch.data.transforms import eval_transform, train_transform

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp", ".npy")


def scan_image_folder(root: str) -> Tuple[List[str], List[Tuple[str, int]]]:
    """Sorted class-subdir scan, torchvision ImageFolder semantics."""
    classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
    samples: List[Tuple[str, int]] = []
    for idx, cls in enumerate(classes):
        cls_dir = os.path.join(root, cls)
        for dirpath, _, filenames in sorted(os.walk(cls_dir)):
            for fname in sorted(filenames):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    samples.append((os.path.join(dirpath, fname), idx))
    return classes, samples


class ImageFolderDataset:
    """List of (path, label) with a transform; optional label-flip noise."""

    def __init__(
        self,
        samples: Sequence[Tuple[str, int]],
        transform: Callable,
        flip_label_prob: float = 0.0,
        num_classes: Optional[int] = None,
        seed: int = 0,
    ):
        self.samples = list(samples)
        self.transform = transform
        if flip_label_prob > 0:
            rng = np.random.default_rng(seed)
            self.samples = [
                (p, int(rng.integers(0, num_classes)) if rng.random() < flip_label_prob else l)
                for p, l in self.samples
            ]

    @classmethod
    def from_root(cls, root: str, transform: Callable, **kw) -> "ImageFolderDataset":
        _, samples = scan_image_folder(root)
        return cls(samples, transform, **kw)

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        path, label = self.samples[idx]
        if not path.endswith(".npy") and hasattr(self.transform, "from_path"):
            # The native decode and transform (no GIL held end to end).
            image = self.transform.from_path(path, rng)
        else:
            from PIL import Image

            if path.endswith(".npy"):
                img = Image.fromarray(np.load(path).astype(np.uint8))
            else:
                img = Image.open(path)
            image = self.transform(img, rng)
        return {
            "image": image.astype(np.float32),
            "label": np.int32(label),
            "path": path,
        }


class SubsetDataset:
    """Fixed-index view of another dataset."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        return self.dataset.get(self.indices[idx], rng)


class VisionDataset:
    """Base class: builds train/test loaders over ImageFolder-style trees.

    ``preprocess`` may be None (CLIP's eval/train transforms at
    ``image_size``) or a callable ``(PIL, rng) -> array``.
    """

    image_size = 224

    def __init__(
        self,
        preprocess=None,
        location: str = os.path.expanduser("~/data"),
        batch_size: int = 32,
        num_workers: int = 8,
        classnames="openai",
        seed: int = 0,
        **kwargs,
    ):
        self.location = location
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        self.preprocess = preprocess or eval_transform(self.image_size)
        self.train_preprocess = preprocess or train_transform(self.image_size)
        self._resolve_classnames(classnames)
        self.populate_train()
        self.populate_test()

    def _resolve_classnames(self, classnames):
        self.classnames = list(classnames) if not isinstance(classnames, str) else None

    # -- hooks ---------------------------------------------------------------

    def populate_train(self) -> None:
        self.train_dataset = None
        self.train_loader = None

    def populate_test(self) -> None:
        self.test_dataset = self.get_test_dataset()
        indices = self.get_test_indices()
        ds = self.test_dataset if indices is None else SubsetDataset(self.test_dataset, indices)
        self.test_loader = DataLoader(
            ds,
            batch_size=self.batch_size,
            shuffle=False,
            drop_last=False,
            num_workers=self.num_workers,
            seed=self.seed,
            # Replicated eval: every process scores the full test set (the
            # evaluator reduces no metric across processes).
            shard_by_process=False,
        )

    def get_test_dataset(self):
        raise NotImplementedError

    def get_test_indices(self) -> Optional[Sequence[int]]:
        return None

    def make_train_loader(self, dataset, shuffle: bool = True, indices=None) -> DataLoader:
        ds = dataset if indices is None else SubsetDataset(dataset, indices)
        return DataLoader(
            ds,
            batch_size=self.batch_size,
            shuffle=shuffle,
            drop_last=False,
            num_workers=self.num_workers,
            seed=self.seed,
        )
