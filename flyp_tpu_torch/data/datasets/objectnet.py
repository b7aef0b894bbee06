"""ObjectNet: metadata-driven 113-class evaluation with a max-pooled logit
projection.

Counterpart of ``flyp_tpu/data/datasets/objectnet.py``; the four metadata
files under ``data/metadata/objectnet/`` are byte-equal copies of the JAX
package's.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from flyp_tpu_torch.data.datasets.base import ImageFolderDataset, scan_image_folder
from flyp_tpu_torch.data.datasets.imagenet import ImageNet

_METADATA = Path(__file__).parent.parent / "metadata" / "objectnet"


def get_metadata():
    """(class sublist, its 1000-wide mask, folder -> ImageNet ids, folder ->
    ObjectNet name)."""
    with open(_METADATA / "folder_to_objectnet_label.json") as f:
        folder_map = {v: k for k, v in json.load(f).items()}
    with open(_METADATA / "objectnet_to_imagenet_1k.json") as f:
        objectnet_map = json.load(f)
    with open(_METADATA / "pytorch_to_imagenet_2012_id.json") as f:
        pytorch_map = {v: k for k, v in json.load(f).items()}
    with open(_METADATA / "imagenet_to_label_2012_v2") as f:
        imagenet_map = {v.strip(): str(pytorch_map[i]) for i, v in enumerate(f)}

    folder_to_ids, class_sublist = {}, []
    for objectnet_name, imagenet_names in objectnet_map.items():
        ids = [int(imagenet_map[n]) for n in imagenet_names.split("; ")]
        class_sublist.extend(ids)
        folder_to_ids[folder_map[objectnet_name]] = ids

    class_sublist = sorted(class_sublist)
    class_sublist_mask = [(i in set(class_sublist)) for i in range(1000)]
    classname_map = {v: k for k, v in folder_map.items()}
    return class_sublist, class_sublist_mask, folder_to_ids, classname_map


def _border_crop(img):
    """Remove ObjectNet's 2-pixel red border."""
    w, h = img.size
    return img.crop((2, 2, w - 2, h - 2))


class _ObjectNetFolderDataset(ImageFolderDataset):
    def __init__(self, samples, transform, label_map):
        super().__init__(samples, transform)
        self.label_map = label_map

    def get(self, idx, rng):
        from PIL import Image

        path, _ = self.samples[idx]
        img = _border_crop(Image.open(path))
        folder = os.path.basename(os.path.dirname(path))
        return {
            "image": self.transform(img, rng).astype(np.float32),
            "label": np.int32(self.label_map[folder]),
            "path": path,
        }


class ObjectNetBase(ImageNet):
    def __init__(self, *args, **kwargs):
        (self._class_sublist, self.class_sublist_mask, self.folders_to_ids, self.classname_map) = get_metadata()
        super().__init__(*args, **kwargs)

        folders = sorted(self.folders_to_ids.keys())
        self.rev_class_idx_map = {i: self.folders_to_ids[name] for i, name in enumerate(folders)}
        self.class_idx_map = {
            imagenet_idx: i for i, ids in self.rev_class_idx_map.items() for imagenet_idx in ids
        }
        self.classnames = [self.classname_map[c].lower() for c in folders]

    def populate_train(self):
        self.train_dataset = None
        self.train_loader = None

    def get_test_dataset(self):
        valdir = os.path.join(self.location, "objectnet-1.0", "images")
        label_map = {name: idx for idx, name in enumerate(sorted(self.folders_to_ids.keys()))}
        _, samples = scan_image_folder(valdir)
        samples = [s for s in samples if os.path.basename(os.path.dirname(s[0])) in label_map]
        return _ObjectNetFolderDataset(samples, self.preprocess, label_map)

    def project_logits(self, logits: np.ndarray) -> np.ndarray:
        """1000-way -> 113-way by the max over each class's ImageNet ids."""
        if logits.shape[1] == 113:
            return logits
        out = np.zeros((logits.shape[0], 113), dtype=logits.dtype)
        for k, ids in self.rev_class_idx_map.items():
            out[:, k] = np.max(logits[:, ids], axis=1)
        return out

    def scatter_weights(self, weights: np.ndarray) -> np.ndarray:
        """113-way head -> 1000-way, -1e9 elsewhere."""
        if weights.shape[1] == 1000:
            return weights
        out = np.full((weights.shape[0], 1000), -10e8, dtype=np.float32)
        for k, ids in self.rev_class_idx_map.items():
            for v in ids:
                out[:, v] = weights[:, k]
        return out


class ObjectNet(ObjectNetBase):
    def accuracy(self, logits, targets, paths, cfg):
        assert logits.shape[1] == 113
        preds = logits.argmax(axis=1)
        return float(np.sum(preds == np.asarray(targets))), len(preds)


class ObjectNetValClasses(ObjectNetBase):
    """The standard ImageNet val set restricted to ObjectNet's classes."""

    def get_test_dataset(self):
        return ImageFolderDataset.from_root(self.get_test_path(), self.preprocess)

    def get_test_indices(self):
        return sorted(i for x in self._class_sublist for i in range(x * 50, (x + 1) * 50))

    def project_labels(self, labels):
        return np.asarray([self.class_idx_map[int(l)] for l in labels], dtype=np.int64)
