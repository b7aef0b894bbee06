"""Transfer and few-shot suites: Caltech-101, StanfordCars, Flowers-102,
PatchCamelyon, SST-2 (rendered text) and OxfordPet.

Counterpart of ``flyp_tpu/data/datasets/transfer.py``.  All are
ImageFolder trees, ``<root>/<dirname>/{train,val,test}``, plus
``train_shot_{k}`` folders for the few-shot binary tasks.  Test loaders are
deterministic (accuracy does not depend on the order).
"""

from __future__ import annotations

import os
from typing import Optional

from flyp_tpu_torch.data.classnames import (
    caltech101_classnames,
    flowers102_classnames,
    patchcamelyon_classnames,
    sst2_classnames,
    stanfordcars_classnames,
)
from flyp_tpu_torch.data.datasets.base import ImageFolderDataset, VisionDataset


class _FolderTransferDataset(VisionDataset):
    dirname: str = ""
    fixed_classnames = None
    test_subset: str = "test"
    supports_k_shot: bool = False

    def __init__(self, preprocess=None, location=os.path.expanduser("~/data"), k: Optional[int] = None, **kwargs):
        self.k = k
        kwargs.pop("subset", None)
        super().__init__(preprocess, location=location, **kwargs)

    def _resolve_classnames(self, classnames):
        self.classnames = list(self.fixed_classnames)

    def _train_location(self) -> str:
        if self.supports_k_shot and self.k is not None:
            return os.path.join(self.location, self.dirname, f"train_shot_{self.k}")
        return os.path.join(self.location, self.dirname, "train")

    def populate_train(self):
        root = self._train_location()
        if os.path.isdir(root):
            self.train_dataset = ImageFolderDataset.from_root(root, self.train_preprocess)
            self.train_loader = self.make_train_loader(self.train_dataset)
        else:
            self.train_dataset = None
            self.train_loader = None

    def get_test_dataset(self):
        return ImageFolderDataset.from_root(
            os.path.join(self.location, self.dirname, self.test_subset), self.preprocess
        )


def _folder_set(name: str, dirname: str, classnames, test_subset: str, k_shot: bool = False):
    return type(name, (_FolderTransferDataset,), {
        "dirname": dirname, "fixed_classnames": classnames, "test_subset": test_subset,
        "supports_k_shot": k_shot, "__module__": __name__,
    })


Caltech101Train = _folder_set("Caltech101Train", "caltech-101", caltech101_classnames, "train")
Caltech101Val = _folder_set("Caltech101Val", "caltech-101", caltech101_classnames, "val")
Caltech101Test = _folder_set("Caltech101Test", "caltech-101", caltech101_classnames, "test")
StanfordCarsTrain = _folder_set("StanfordCarsTrain", "StanfordCars", stanfordcars_classnames, "train")
StanfordCarsVal = _folder_set("StanfordCarsVal", "StanfordCars", stanfordcars_classnames, "val")
StanfordCarsTest = _folder_set("StanfordCarsTest", "StanfordCars", stanfordcars_classnames, "test")
Flowers102Train = _folder_set("Flowers102Train", "flowers102", flowers102_classnames, "train")
Flowers102Val = _folder_set("Flowers102Val", "flowers102", flowers102_classnames, "val")
Flowers102Test = _folder_set("Flowers102Test", "flowers102", flowers102_classnames, "test")
PatchCamelyonTrain = _folder_set("PatchCamelyonTrain", "patchcamelyon", patchcamelyon_classnames, "train", True)
PatchCamelyonVal = _folder_set("PatchCamelyonVal", "patchcamelyon", patchcamelyon_classnames, "val", True)
PatchCamelyonTest = _folder_set("PatchCamelyonTest", "patchcamelyon", patchcamelyon_classnames, "test", True)
SST2Train = _folder_set("SST2Train", "sst2", sst2_classnames, "train", True)
SST2Val = _folder_set("SST2Val", "sst2", sst2_classnames, "val", True)
SST2Test = _folder_set("SST2Test", "sst2", sst2_classnames, "test", True)


# OxfordPet: torchvision's OxfordIIITPet layout, images/ and annotations/.
_OXFORD_CAT_BREEDS = [
    "Abyssinian", "Bengal", "Birman", "Bombay", "British Shorthair",
    "Egyptian Mau", "English Cocker Spaniel", "Maine Coon", "Persian",
    "Ragdoll", "Russian Blue", "Siamese", "Sphynx",
]


class OxfordPet(VisionDataset):
    """The 37-breed OxfordIIITPet test split with its cat and dog index
    lists.  Layout: ``<root>/OxfordPets/test/oxford-iiit-pet/{images,
    annotations}``."""

    test_subset = "test"

    def _resolve_classnames(self, classnames):
        self.classnames = None  # read from the annotations at load time

    def _pet_root(self) -> str:
        return os.path.join(self.location, "OxfordPets", self.test_subset, "oxford-iiit-pet")

    def populate_train(self):
        self.train_dataset = None
        self.train_loader = None

    def get_test_dataset(self):
        root = self._pet_root()
        with open(os.path.join(root, "annotations", "test.txt")) as f:
            rows = [line.split() for line in f if line.strip() and not line.startswith("#")]

        # torchvision's class names: the breed up to the trailing _<index>,
        # title-cased, with spaces.
        def breed(stem):
            return " ".join(p.title() for p in stem.rsplit("_", 1)[0].split("_"))

        names = sorted({breed(r[0]) for r in rows})
        self.classnames = names
        samples = [
            (os.path.join(root, "images", r[0] + ".jpg"), names.index(breed(r[0]))) for r in rows
        ]
        self.class_cat = [n for n in names if n in _OXFORD_CAT_BREEDS]
        self.index_cat = [i for i, n in enumerate(names) if n in _OXFORD_CAT_BREEDS]
        self.index_dog = [i for i, n in enumerate(names) if n not in _OXFORD_CAT_BREEDS]
        return ImageFolderDataset(samples, self.preprocess)


class OxfordPetVal(OxfordPet):
    test_subset = "test"  # 'val' reads the test split too


class OxfordPetTest(OxfordPet):
    test_subset = "test"
