"""WILDS iWildCam and FMoW suites, read from the releases on disk.

Counterpart of ``flyp_tpu/data/datasets/wilds_sets.py``:

* iWildCam v2.0: ``<root>/iwildcam_v2.0/`` with ``metadata.csv`` (columns
  ``split``, ``filename``, ``y``, ``image_id``), images under ``train/``,
  and the MegaDetector results JSON for the non-empty filter (threshold
  0.95).  Headline metric: macro F1 over the classes present
  (``F1-macro_all``).
* FMoW v1.1: ``<root>/fmow_v1.1/`` with ``rgb_metadata.csv`` (columns
  ``split``, ``timestamp``, ``category`` and ``region`` or
  ``country_code``), images ``images/rgb_img_{i}.png``.  Headline metric:
  worst-region accuracy (``acc_worst_region``).

pandas reads the metadata and is imported inside the readers, so the rest
of the package imports without it; iWildCam's class names (the packaged
``labels.csv``) are read with the ``csv`` module.
"""

from __future__ import annotations

import csv
import json
import os
import pathlib
from typing import List, Optional

import numpy as np

from flyp_tpu_torch.data.classnames import fmow_classnames
from flyp_tpu_torch.data.datasets.base import VisionDataset
from flyp_tpu_torch.evaluation.metrics import macro_f1

_IWILDCAM_LABELS = pathlib.Path(__file__).parent.parent / "metadata" / "iwildcam" / "labels.csv"


def iwildcam_english_names() -> List[str]:
    """The ``english`` column of the packaged ``labels.csv`` for the rows
    with ``y < 99999``, as written (callers lower-case them)."""
    with open(_IWILDCAM_LABELS, newline="") as f:
        return [row["english"] for row in csv.DictReader(f) if int(row["y"]) < 99999]


class _WildsImageDataset:
    def __init__(self, paths: List[str], labels: np.ndarray, metadata: Optional[np.ndarray], transform):
        self.paths = paths
        self.labels = labels
        self.metadata = metadata
        self.transform = transform

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        path = self.paths[idx]
        if hasattr(self.transform, "from_path"):
            # The native decode and transform, as ImageFolderDataset.get.
            image = self.transform.from_path(path, rng)
        else:
            from PIL import Image

            image = self.transform(Image.open(path), rng)
        sample = {
            "image": image.astype(np.float32),
            "label": np.int32(self.labels[idx]),
            "path": path,
        }
        if self.metadata is not None:
            sample["metadata"] = self.metadata[idx]
        return sample


class IWildCam(VisionDataset):
    subset = "train"
    remove_non_empty = False

    def __init__(self, preprocess=None, location=os.path.expanduser("~/data"), remove_non_empty=False, **kwargs):
        self.remove_non_empty = remove_non_empty or self.remove_non_empty
        kwargs.setdefault("subset", None)
        self._subset_override = kwargs.pop("subset")
        super().__init__(preprocess, location=location, **kwargs)

    def _resolve_classnames(self, classnames):
        self.classnames = [s.lower() for s in iwildcam_english_names()]

    def _data_dir(self) -> pathlib.Path:
        return pathlib.Path(self.location) / "iwildcam_v2.0"

    def _load_split(self, split: str):
        # The metadata and the MegaDetector JSON are parsed once per
        # instance: populate_train and populate_test both come here.
        if not hasattr(self, "_meta_cache"):
            import pandas as pd

            meta = pd.read_csv(self._data_dir() / "metadata.csv")
            conf = None
            if self.remove_non_empty:
                with open(self._data_dir() / "iwildcam2020_megadetector_results.json") as f:
                    md = json.load(f)
                conf = {x["id"]: x["max_detection_conf"] for x in md["images"]}
            self._meta_cache = (meta, conf)
        meta, conf = self._meta_cache
        mask = meta["split"] == split
        if self.remove_non_empty:
            mask = mask & meta["image_id"].map(lambda i: conf.get(i, 0.0) >= 0.95)
        sub = meta[mask]
        paths = [str(self._data_dir() / "train" / fn) for fn in sub["filename"]]
        return paths, sub["y"].to_numpy(np.int64)

    def populate_train(self):
        paths, labels = self._load_split("train")
        self.train_dataset = _WildsImageDataset(paths, labels, None, self.train_preprocess)
        self.train_loader = self.make_train_loader(self.train_dataset)

    def get_test_dataset(self):
        split = self._subset_override or self.subset
        paths, labels = self._load_split(split)
        return _WildsImageDataset(paths, labels, None, self.preprocess)

    def post_loop_metrics(self, labels, logits, metadata, cfg):
        preds = np.asarray(logits).argmax(axis=1)
        labels = np.asarray(labels)
        return {
            "acc_avg": float((preds == labels).mean()),
            # WILDS averages F1 over the label set present.
            "F1-macro_all": macro_f1(preds, labels, num_classes=None),
        }


class IWildCamIDVal(IWildCam):
    subset = "id_val"


class IWildCamID(IWildCam):
    subset = "id_test"


class IWildCamOOD(IWildCam):
    subset = "test"


class IWildCamNonEmpty(IWildCam):
    subset = "train"
    remove_non_empty = True


class IWildCamIDNonEmpty(IWildCam):
    subset = "id_test"
    remove_non_empty = True


class IWildCamOODNonEmpty(IWildCam):
    subset = "test"
    remove_non_empty = True


class FMOW(VisionDataset):
    test_subset = "test"

    def _resolve_classnames(self, classnames):
        self.classnames = list(fmow_classnames)

    def _data_dir(self) -> pathlib.Path:
        return pathlib.Path(self.location) / "fmow_v1.1"

    def _load_split(self, split: str):
        """WILDS's splits over rgb_metadata.csv: the OOD axis is the year,
        intersected with the original split column (OOD test = year >= 2016
        and split 'test'; OOD val = 2013-2015 and split 'val'); the ID splits
        keep the original assignment before 2013; 'seq' rows are dropped."""
        if not hasattr(self, "_meta_cache"):
            import pandas as pd

            meta = pd.read_csv(self._data_dir() / "rgb_metadata.csv")
            meta = meta.reset_index().rename(columns={"index": "img_idx"})
            meta = meta[meta["split"] != "seq"]
            years = pd.to_datetime(meta["timestamp"], utc=True, format="mixed").dt.year
            self._meta_cache = (meta, years)  # parsed once: to_datetime(mixed) is slow at 500k rows
        meta, years = self._meta_cache
        test_ood = years >= 2016
        val_ood = (years >= 2013) & ~test_ood
        ood = test_ood | val_ood

        if split == "train":
            mask = (meta["split"] == "train") & ~ood
        elif split == "id_val":
            mask = (meta["split"] == "val") & ~ood
        elif split == "id_test":
            mask = (meta["split"] == "test") & ~ood
        elif split == "val":
            mask = val_ood & (meta["split"] == "val")
        elif split == "test":
            mask = test_ood & (meta["split"] == "test")
        else:
            raise ValueError(f"unknown fmow split {split!r}")

        sub = meta[mask]
        paths = [str(self._data_dir() / "images" / f"rgb_img_{i}.png") for i in sub["img_idx"]]
        labels = np.asarray([self.classnames.index(c) for c in sub["category"]], dtype=np.int64)
        regions = self._regions_for(sub)
        return paths, labels, regions

    def _regions_for(self, sub) -> np.ndarray:
        """Region of each row, for the worst-region metric: a ``region``
        column where there is one, else ``country_code`` through
        ``country_code_mapping.csv`` (unknown codes are ``"Other"``), else
        ``"Other"`` for every row."""
        import pandas as pd

        if "region" in sub.columns:
            return sub["region"].to_numpy()
        mapping_path = self._data_dir() / "country_code_mapping.csv"
        if "country_code" in sub.columns and mapping_path.exists():
            mapping_df = pd.read_csv(mapping_path)
            code_col = next((c for c in mapping_df.columns if "country" in c.lower() or "code" in c.lower()), None)
            region_col = next((c for c in mapping_df.columns if "region" in c.lower()), None)
            if code_col and region_col:
                code_to_region = dict(zip(mapping_df[code_col].astype(str), mapping_df[region_col].astype(str)))
                return sub["country_code"].astype(str).map(lambda c: code_to_region.get(c, "Other")).to_numpy()
        if "country_code" in sub.columns:
            # Without the mapping, raw country codes would make the worst
            # region a minimum over tiny per-country groups: every row is
            # "Other" (left out of the headline minimum), with a warning.
            import logging

            logging.getLogger("flyp_tpu_torch").warning(
                "fmow: country_code_mapping.csv not found under %s; regions "
                "fall back to 'Other' and acc_worst_region degrades to the "
                "overall accuracy",
                self._data_dir(),
            )
            return np.asarray(["Other"] * len(sub))
        return np.asarray(["Other"] * len(sub))

    def populate_train(self):
        paths, labels, regions = self._load_split("train")
        self.train_dataset = _WildsImageDataset(paths, labels, regions, self.train_preprocess)
        self.train_loader = self.make_train_loader(self.train_dataset)

    def get_test_dataset(self):
        paths, labels, regions = self._load_split(self.test_subset)
        return _WildsImageDataset(paths, labels, regions, self.preprocess)

    def post_loop_metrics(self, labels, logits, metadata, cfg):
        preds = np.asarray(logits).argmax(axis=1)
        labels = np.asarray(labels)
        regions = np.asarray(metadata)
        out = {"acc_avg": float((preds == labels).mean())}
        region_accs = []
        for r in np.unique(regions):
            sel = regions == r
            acc = float((preds[sel] == labels[sel]).mean())
            out[f"acc_region:{r}"] = acc
            # The worst over the five named regions only: 'Other' is
            # reported, but left out of the headline minimum.
            if str(r).lower() not in ("other", "unknown"):
                region_accs.append(acc)
        out["acc_worst_region"] = min(region_accs) if region_accs else out["acc_avg"]
        return out


class FMOWIDVal(FMOW):
    test_subset = "id_val"


class FMOWID(FMOW):
    test_subset = "id_test"


class FMOWOOD(FMOW):
    test_subset = "test"
