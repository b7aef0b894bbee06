"""Class names for a dataset name, from packaged assets alone.

Counterpart of ``get_classnames_for`` in ``flyp_tpu/data/registry.py``,
for the zero-shot head of ``cli/serve.py --train-dataset``.  The dataset
classes themselves are not ported yet; ObjectNet's class list needs their
metadata and raises.
"""

from __future__ import annotations

import csv
import pathlib
from typing import List

from flyp_tpu_torch.data.classnames import (
    IMAGENET_A_SUBLIST,
    IMAGENET_R_SUBLIST,
    caltech101_classnames,
    flowers102_classnames,
    fmow_classnames,
    get_classnames,
    patchcamelyon_classnames,
    sst2_classnames,
    stanfordcars_classnames,
)

_ALIASES = {"sst2Val": "SST2Val", "sst2Test": "SST2Test", "sst2Train": "SST2Train"}

_SPLITS = ("Train", "Val", "Test")
_FIXED = {
    "Caltech101": caltech101_classnames,
    "StanfordCars": stanfordcars_classnames,
    "Flowers102": flowers102_classnames,
    "PatchCamelyon": patchcamelyon_classnames,
    "SST2": sst2_classnames,
}
_IMAGENET = (
    "ImageNet", "ImageNet1", "ImageNet2", "ImageNet4", "ImageNet8", "ImageNet16", "ImageNet25", "ImageNet32",
    "ImageNet50", "ImageNet64", "ImageNet128", "ImageNet600", "ImageNetA", "ImageNetAValClasses", "ImageNetK",
    "ImageNetKShot", "ImageNetR", "ImageNetRValClasses", "ImageNetSketch", "ImageNetSubsample",
    "ImageNetSubsampleValClasses", "ImageNetTrain", "ImageNetV2", "ImageNetVidRobust",
    "ImageNetVidRobustValClasses",
)
_IWILDCAM = (
    "IWildCam", "IWildCamID", "IWildCamIDNonEmpty", "IWildCamIDVal", "IWildCamNonEmpty", "IWildCamOOD",
    "IWildCamOODNonEmpty",
)
_FMOW = ("FMOW", "FMOWID", "FMOWIDVal", "FMOWOOD")
KNOWN_DATASETS = frozenset(
    [f"{base}{split}" for base in _FIXED for split in _SPLITS] + list(_IMAGENET + _IWILDCAM + _FMOW)
)


def _iwildcam_classnames() -> List[str]:
    labels = pathlib.Path(__file__).parent / "metadata" / "iwildcam" / "labels.csv"
    with open(labels, newline="") as f:
        return [row["english"].lower() for row in csv.DictReader(f) if int(row["y"]) < 99999]


def get_classnames_for(name: str) -> List[str]:
    name = _ALIASES.get(name, name)
    if name.startswith("ObjectNet"):
        raise KeyError(f"{name}: ObjectNet's class list comes with the dataset port (ROADMAP.md, data layer)")
    if name not in KNOWN_DATASETS:
        raise KeyError(f"no packaged classnames for {name!r}; known: {sorted(KNOWN_DATASETS)}")
    for prefix, names in _FIXED.items():
        if name.startswith(prefix):
            return list(names)
    if name.startswith("IWildCam"):
        return _iwildcam_classnames()
    if name.startswith("FMOW"):
        return list(fmow_classnames)
    if "VidRobust" in name:
        return get_classnames("imagenet_vid_robust_classnames")
    base = get_classnames("openai")
    if name.startswith("ImageNetR"):
        return [base[i] for i in IMAGENET_R_SUBLIST]
    if name.startswith("ImageNetA"):
        return [base[i] for i in IMAGENET_A_SUBLIST]
    return list(base)
