"""ImageNet-Vid-Robust: anchor and perturbation-set scoring (pm0, pm10).

Counterpart of ``flyp_tpu/data/datasets/vid_robust.py``.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np

from flyp_tpu_torch.data.datasets.base import ImageFolderDataset, scan_image_folder
from flyp_tpu_torch.data.datasets.imagenet import ImageNet


class _VidRobustDataset(ImageFolderDataset):
    def __init__(self, samples, transform, label_map):
        super().__init__(samples, transform)
        self.label_map = label_map

    def get(self, idx, rng):
        sample = super().get(idx, rng)
        key = "/".join(sample["path"].split("/")[-3:])
        sample["label"] = np.int32(self.label_map[key][0])
        return sample


class ImageNetVidRobustBase(ImageNet):
    def __init__(self, *args, **kwargs):
        # ``location`` may come positionally (VisionDataset's second
        # parameter) or by keyword; the metadata is read from the same root
        # as the images.
        if len(args) >= 2:
            location = args[1]
        else:
            location = kwargs.get("location", os.path.expanduser("~/data"))
        data_loc = pathlib.Path(location) / "imagenet_vid_ytbb_robust/imagenet-vid-robust"
        with open(data_loc / "misc/wnid_map.json") as f:
            self.wnid_map = json.load(f)
        with open(data_loc / "misc/rev_wnid_map.json") as f:
            self.rev_wnid_map = json.load(f)
        with open(data_loc / "misc/imagenet_class_index.json") as f:
            self.imagenet_class_index = json.load(f)
        with open(data_loc / "misc/imagenet_vid_class_index.json") as f:
            self.imagenet_vid_class_index = json.load(f)
        with open(data_loc / "metadata/labels.json") as f:
            self.label_map = json.load(f)
        with open(data_loc / "metadata/pmsets.json") as f:
            self.pmsets = json.load(f)

        rev_imagenet = {v[0]: k for k, v in self.imagenet_class_index.items()}
        rev_vid = {v[0]: k for k, v in self.imagenet_vid_class_index.items()}
        self.CLASS_IDX_LIST = sorted(int(rev_imagenet[k]) for k in self.wnid_map)
        self.CLASS_IDX_MAP = {int(rev_imagenet[k]): int(rev_vid[v]) for k, v in self.wnid_map.items()}
        self.rev_class_idx_map = {
            int(rev_vid[k]): [int(rev_imagenet[e]) for e in v] for k, v in self.rev_wnid_map.items()
        }
        self.merge_op = "max"

        super().__init__(*args, **kwargs)
        self.classnames = [self.imagenet_vid_class_index[str(i)][1] for i in range(30)]

    def populate_train(self):
        self.train_dataset = None
        self.train_loader = None

    def project_logits(self, logits: np.ndarray) -> np.ndarray:
        if logits.shape[1] == 30:
            return logits
        out = np.zeros((logits.shape[0], 30), dtype=logits.dtype)
        merge = {"mean": np.mean, "median": np.median, "max": np.max, "sum": np.sum}[self.merge_op]
        for k, ids in self.rev_class_idx_map.items():
            out[:, k] = merge(logits[:, ids], axis=1)
        return out

    def scatter_weights(self, weights: np.ndarray) -> np.ndarray:
        if weights.shape[1] == 1000:
            return weights
        out = np.full((weights.shape[0], 1000), -10e10, dtype=np.float32)
        for k, ids in self.rev_class_idx_map.items():
            for v in ids:
                out[:, v] = weights[:, k]
        return out


class ImageNetVidRobustValClasses(ImageNetVidRobustBase):
    def get_test_indices(self):
        return sorted(i for x in self.CLASS_IDX_LIST for i in range(x * 50, (x + 1) * 50))

    def project_labels(self, labels):
        return np.asarray([self.CLASS_IDX_MAP[int(l)] for l in labels], dtype=np.int64)

    def post_loop_metrics(self, targets, logits, image_paths, cfg):
        return {"acc": float((logits.argmax(axis=1) == targets).mean())}


class ImageNetVidRobust(ImageNetVidRobustBase):
    def get_test_dataset(self):
        valdir = os.path.join(self.location, "imagenet_vid_ytbb_robust/imagenet-vid-robust/val")
        _, samples = scan_image_folder(valdir)
        return _VidRobustDataset(samples, self.preprocess, self.label_map)

    def score_predictions(self, preds: dict, pmsets: dict):
        """Anchor (pm0) and whole-perturbation-set (pm10) accuracy."""
        correct_anchor = 0
        correct_pmk = 0
        n = len(pmsets)
        for anchor, pmset in pmsets.items():
            pmset_correct = sum(1 for e in pmset if np.argmax(preds[e]) in self.label_map[e])
            if np.argmax(preds[anchor]) in self.label_map[anchor]:
                correct_anchor += 1
                pmset_correct += 1
            if pmset_correct == len(pmset) + 1:
                correct_pmk += 1
        return correct_anchor / n, correct_pmk / n

    def post_loop_metrics(self, labels, logits, image_paths, cfg):
        # Keyed by 'val/<video>/<frame>', the path's last three parts (as
        # _VidRobustDataset.get keys its labels).
        preds = {"/".join(p.split("/")[-3:]): logits[i] for i, p in enumerate(image_paths)}
        pm0, pm10 = self.score_predictions(preds, self.pmsets)
        return {"pm0": pm0, "pm10": pm10, "merge_op": self.merge_op}
