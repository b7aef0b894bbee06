"""Name -> dataset class, and a dataset's class names from packaged assets.

Counterpart of ``flyp_tpu/data/registry.py``.  ``get_classnames_for`` reads
no dataset tree: the zero-shot head needs only the names, and for every
suite but OxfordPet (whose names come from its annotations) they come with
the package.  iWildCam's ``labels.csv`` is read without pandas.
"""

from __future__ import annotations

from typing import List

from flyp_tpu_torch.data import datasets as _datasets

# The lower-case aliases of the reference's registry.
_ALIASES = {
    "sst2Val": "SST2Val",
    "sst2Test": "SST2Test",
    "sst2Train": "SST2Train",
}


def get_dataset_class(name: str):
    name = _ALIASES.get(name, name)
    cls = getattr(_datasets, name, None)
    if cls is None:
        known = sorted(n for n in dir(_datasets) if not n.startswith("_"))
        raise KeyError(f"unknown dataset {name!r}; known: {known}")
    return cls


def get_classnames_for(name: str, cfg=None) -> List[str]:
    """Class names of the dataset ``name`` without reading its tree.
    ``cfg`` (its ``data_location``) is taken for the JAX signature; no
    suite's names need it."""
    from flyp_tpu_torch.data.classnames import (
        IMAGENET_A_SUBLIST,
        IMAGENET_R_SUBLIST,
        fmow_classnames,
        get_classnames,
    )

    name = _ALIASES.get(name, name)
    cls = get_dataset_class(name)

    fixed = getattr(cls, "fixed_classnames", None)
    if fixed is not None:
        return list(fixed)

    if name.startswith("IWildCam"):
        from flyp_tpu_torch.data.datasets.wilds_sets import iwildcam_english_names

        return [s.lower() for s in iwildcam_english_names()]

    if name.startswith("FMOW"):
        return list(fmow_classnames)

    if name.startswith("ObjectNet"):
        from flyp_tpu_torch.data.datasets.objectnet import get_metadata

        _, _, folder_to_ids, classname_map = get_metadata()
        return [classname_map[c].lower() for c in sorted(folder_to_ids.keys())]

    if "VidRobust" in name:
        return get_classnames("imagenet_vid_robust_classnames")

    base = get_classnames("openai")
    if name.startswith("ImageNetR"):
        return [base[i] for i in IMAGENET_R_SUBLIST]
    if name.startswith("ImageNetA") and name != "ImageNetAll":
        return [base[i] for i in IMAGENET_A_SUBLIST]
    if name.startswith("ImageNet"):
        return list(base)
    if name.startswith("OxfordPet"):
        raise KeyError("OxfordPet classnames require the on-disk annotations; instantiate the dataset")
    raise KeyError(f"no static classnames for {name!r}")
