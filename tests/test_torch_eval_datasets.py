"""The port's dataset suites and registry against the JAX package's, on the CPU.

One synthetic tree of every suite (ImageNet with and without ``val_dirs``,
V2, R, A, Sketch, ObjectNet, ImageNet-Vid-Robust, iWildCam with its
MegaDetector results, FMoW with each source of regions, the folder
transfer sets, OxfordPet) goes through ``flyp_tpu.data.datasets`` and
``flyp_tpu_torch.data.datasets``, each with its own package's eval
transform.  Class names, samples, every batch of the test loader (and the
first of the train loader) must be bit-equal, and every hook must give
equal output on seeded inputs.

Every image is one flat colour that encodes a slot (``slot_color``), which
``tests/test_torch_eval.py``'s classifier reads back as the class it
predicts, so that the evaluation harness has known answers.
"""

import json
import logging
import os
import pathlib
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import flyp_tpu.data.datasets as jax_datasets
from flyp_tpu.data import registry as jax_registry
from flyp_tpu.data.transforms import eval_transform as jax_eval_transform
from flyp_tpu_torch.data import datasets as port_datasets
from flyp_tpu_torch.data import registry as port_registry
from flyp_tpu_torch.data.transforms import eval_transform as port_eval_transform

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PX = 16
STEP = 10  # colour levels 0, 10, ..., 250 per channel
LEVELS = 26

# A slot for each image; the classifier of test_torch_eval.py maps a slot
# back to the column it predicts.
PREDICT: dict = {}


def slot_color(slot: int) -> tuple:
    return (STEP * (slot // LEVELS ** 2), STEP * (slot // LEVELS % LEVELS), STEP * (slot % LEVELS))


def save_image(path, pred: int, size=(20, 24)):
    """A flat image whose colour encodes a new slot that predicts column
    ``pred``."""
    slot = len(PREDICT)
    PREDICT[slot] = pred
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.full((*size, 3), slot_color(slot), np.uint8)).save(path)


def _folder_tree(root, classes, per_class, preds, ext=".png", size=(20, 24)):
    """``root/<class>/<i><ext>``, the i-th image of class k predicting
    ``preds(k, i)``."""
    for k, cls in enumerate(classes):
        for i in range(per_class):
            save_image(os.path.join(root, cls, f"{i}{ext}"), preds(k, i), size)


def _imagenet(root):
    base = os.path.join(root, "ILSVRC2012")
    classes = ["n00", "n01", "n02"]
    _folder_tree(os.path.join(base, "val"), classes, 2, lambda k, i: k if i == 0 else (k + 1) % 3)
    _folder_tree(os.path.join(base, "train"), classes, 2, lambda k, i: k)
    with open(os.path.join(base, "val", "n00", "notes.txt"), "w") as f:  # not an image
        f.write("x")


def _shifts(root):
    v2 = os.path.join(root, "ImageNetV2-matched-frequency")
    _folder_tree(v2, ["0", "5", "999"], 2, lambda k, i: (0, 5, 999)[k] if i == 0 else 7)
    os.makedirs(os.path.join(v2, "extra"), exist_ok=True)  # not a number: skipped
    save_image(os.path.join(v2, "extra", "x.png"), 0)
    with open(os.path.join(v2, "5", "checksum.md5"), "w") as f:
        f.write("0")
    from flyp_tpu.data.classnames import IMAGENET_A_SUBLIST, IMAGENET_R_SUBLIST

    # ImageNet-R/A: sublist folders (labels are their sorted positions).
    _folder_tree(os.path.join(root, "imagenet-r"), ["a1", "a2", "a3"], 2,
                 lambda k, i: IMAGENET_R_SUBLIST[k] if i == 0 else IMAGENET_R_SUBLIST[k + 5])
    _folder_tree(os.path.join(root, "imagenet-a"), ["b1", "b2"], 2,
                 lambda k, i: IMAGENET_A_SUBLIST[k] if i else 3)
    _folder_tree(os.path.join(root, "sketch"), ["n00", "n01"], 2, lambda k, i: k)


def _objectnet(root):
    from flyp_tpu.data.datasets.objectnet import get_metadata

    _, _, folder_to_ids, _ = get_metadata()
    folders = sorted(folder_to_ids)
    images = os.path.join(root, "objectnet-1.0", "images")
    for n, folder in enumerate(folders[:3] + folders[-2:]):
        ids = folder_to_ids[folder]
        save_image(os.path.join(images, folder, "a.png"), ids[-1], size=(30, 26))  # right (max-pool)
        other = folder_to_ids[folders[(folders.index(folder) + 7) % len(folders)]][0]
        save_image(os.path.join(images, folder, "b.png"), other, size=(30, 26))  # wrong
    save_image(os.path.join(images, "not_an_objectnet_folder", "c.png"), 1)  # filtered out


def _vid_robust(root):
    base = pathlib.Path(root) / "imagenet_vid_ytbb_robust" / "imagenet-vid-robust"
    (base / "misc").mkdir(parents=True)
    (base / "metadata").mkdir(parents=True)
    wnid_map = {"n100": "v000", "n101": "v001", "n102": "v001", "n103": "v002"}
    rev_wnid_map = {"v000": ["n100"], "v001": ["n101", "n102"], "v002": ["n103"]}
    imagenet_class_index = {str(i): [f"n{100 + i}", f"cls{i}"] for i in range(4)}
    vid_class_index = {"0": ["v000", "vidA"], "1": ["v001", "vidB"], "2": ["v002", "vidC"]}
    for i in range(3, 30):
        vid_class_index[str(i)] = [f"vx{i}", f"vid{i}"]
    labels = {
        "val/vidA/anchor.png": [0], "val/vidA/f1.png": [0], "val/vidA/f2.png": [0, 1],
        "val/vidB/anchor.png": [1], "val/vidB/f1.png": [1], "val/vidB/f2.png": [1], "val/vidB/f3.png": [1],
        "val/vidC/anchor.png": [2], "val/vidC/f1.png": [2],
    }
    pmsets = {
        "val/vidA/anchor.png": ["val/vidA/f1.png", "val/vidA/f2.png"],
        "val/vidB/anchor.png": ["val/vidB/f1.png", "val/vidB/f2.png", "val/vidB/f3.png"],
        "val/vidC/anchor.png": ["val/vidC/f1.png"],
    }
    for name, obj in (("misc/wnid_map.json", wnid_map), ("misc/rev_wnid_map.json", rev_wnid_map),
                      ("misc/imagenet_class_index.json", imagenet_class_index),
                      ("misc/imagenet_vid_class_index.json", vid_class_index),
                      ("metadata/labels.json", labels), ("metadata/pmsets.json", pmsets)):
        with open(base / name, "w") as f:
            json.dump(obj, f)
    wanted = {"val/vidA/anchor.png": 0, "val/vidA/f1.png": 0, "val/vidA/f2.png": 2, "val/vidB/anchor.png": 1,
              "val/vidB/f1.png": 2, "val/vidB/f2.png": 3, "val/vidB/f3.png": 1, "val/vidC/anchor.png": 0,
              "val/vidC/f1.png": 3}
    for key, pred in wanted.items():
        save_image(str(base / key), pred)


def _iwildcam(root):
    d = pathlib.Path(root) / "iwildcam_v2.0"
    rows, md = [], []
    spec = [("train", 0, 0.99), ("train", 1, 0.10), ("id_val", 0, 0.99), ("test", 1, 0.99), ("test", 0, 0.99),
            ("test", 5, 0.30), ("test", 5, 0.97), ("test", 120, 0.99), ("id_test", 1, 0.50), ("test", 0, 0.2), ("id_test", 3, 0.99)]
    for i, (split, y, conf) in enumerate(spec):
        fname = f"img_{i}.png"
        save_image(str(d / "train" / fname), y if i % 3 else (y + 1) % 182)
        rows.append({"split": split, "filename": fname, "y": y, "image_id": f"id{i}"})
        md.append({"id": f"id{i}", "max_detection_conf": conf})
    pd.DataFrame(rows).to_csv(d / "metadata.csv", index=False)
    with open(d / "iwildcam2020_megadetector_results.json", "w") as f:
        json.dump({"images": md}, f)


FMOW_ROWS = [
    ("train", "2010-05-01T00:00:00Z", "airport", "Asia", "JPN"),
    ("train", "2011-05-01T00:00:00Z", "barn", "Europe", "FRA"),
    ("train", "2014-05-01T00:00:00Z", "port", "Asia", "JPN"),
    ("val", "2012-05-01T00:00:00Z", "airport", "Africa", "KEN"),
    ("val", "2014-05-01T00:00:00Z", "barn", "Asia", "JPN"),
    ("test", "2012-06-01T00:00:00Z", "port", "Europe", "FRA"),
    ("test", "2017-01-01T00:00:00Z", "airport", "Americas", "USA"),
    ("test", "2016-03-01 10:00:00", "barn", "Asia", "JPN"),
    ("test", "2018-07-01T00:00:00Z", "port", "Other", "XXX"),
    ("test", "2017-02-01T00:00:00Z", "airport", "Americas", "BRA"),
    ("seq", "2017-01-01T00:00:00Z", "barn", "Asia", "JPN"),
    ("train", "2017-03-01T00:00:00Z", "barn", "Asia", "JPN"),
    ("test", "2014-06-01T00:00:00Z", "port", "Europe", "FRA"),
]


def _fmow(root, source):
    """``source``: "region" (a region column), "mapping" (country codes and
    the mapping file) or "codes" (country codes alone)."""
    from flyp_tpu.data.classnames import fmow_classnames

    d = pathlib.Path(root) / "fmow_v1.1"
    os.makedirs(d / "images", exist_ok=True)
    meta = []
    for i, (split, t, cat, region, code) in enumerate(FMOW_ROWS):
        row = {"split": split, "timestamp": t, "category": cat}
        row.update({"region": region} if source == "region" else {"country_code": code})
        meta.append(row)
        c = fmow_classnames.index(cat)
        save_image(str(d / "images" / f"rgb_img_{i}.png"), c if i % 4 else (c + 1) % 62)
    pd.DataFrame(meta).to_csv(d / "rgb_metadata.csv", index=False)
    if source == "mapping":
        pd.DataFrame([{"country_code": c, "region": r} for c, r in
                      (("JPN", "Asia"), ("FRA", "Europe"), ("KEN", "Africa"), ("USA", "Americas"))]
                     ).to_csv(d / "country_code_mapping.csv", index=False)


def _transfer(root):
    for dirname in ("caltech-101", "patchcamelyon", "sst2"):
        for split in ("train", "val", "test", "train_shot_4"):
            if dirname == "caltech-101" and split == "train_shot_4":
                continue
            _folder_tree(os.path.join(root, dirname, split), ["c0", "c1", "c2"], 2,
                         lambda k, i: k if i else (k + 2) % 3)
    pet = os.path.join(root, "OxfordPets", "test", "oxford-iiit-pet")
    rows = []
    for n, stem in enumerate(["Abyssinian_1", "Bengal_12", "beagle_3", "great_pyrenees_7", "Abyssinian_4",
                              "beagle_9"]):
        save_image(os.path.join(pet, "images", stem + ".jpg"), n % 4)
        rows.append(f"{stem} {n % 4 + 1} 1 1")
    os.makedirs(os.path.join(pet, "annotations"), exist_ok=True)
    with open(os.path.join(pet, "annotations", "test.txt"), "w") as f:
        f.write("# comment\n" + "\n".join(rows) + "\n")


def write_trees(root) -> dict:
    """Every suite's tree under ``root``: {key: location}."""
    roots = {k: os.path.join(root, k) for k in ("main", "valdirs", "fmow_mapping", "fmow_codes")}
    main = roots["main"]
    _imagenet(main)
    _shifts(main)
    _objectnet(main)
    _vid_robust(main)
    _iwildcam(main)
    _fmow(main, "region")
    _transfer(main)
    _imagenet(roots["valdirs"])
    _folder_tree(os.path.join(roots["valdirs"], "ILSVRC2012", "val_dirs"), ["n00", "n01"], 1, lambda k, i: k)
    _fmow(roots["fmow_mapping"], "mapping")
    _fmow(roots["fmow_codes"], "codes")
    return roots


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return write_trees(str(tmp_path_factory.mktemp("eval_trees")))


def make_pair(name, location, positional=False, **kw):
    """The JAX and the port's instance of dataset ``name``."""
    out = []
    for reg, tf in ((jax_registry, jax_eval_transform), (port_registry, port_eval_transform)):
        cls = reg.get_dataset_class(name)
        args = dict(batch_size=4, num_workers=1, **kw)
        if positional:
            out.append(cls(tf(PX), location, **args))
        else:
            out.append(cls(preprocess=tf(PX), location=location, **args))
    return out


def assert_batches_equal(ours, ref):
    assert list(ours) == list(ref)
    for k in ref:
        if isinstance(ref[k], (np.ndarray, np.generic)):
            assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        elif isinstance(ref[k], str):
            assert ours[k] == ref[k], k
        else:
            assert list(ours[k]) == list(ref[k]), k


def _samples(ds):
    if ds is None:
        return None
    if hasattr(ds, "samples"):
        return list(ds.samples)
    if hasattr(ds, "indices"):
        return (list(ds.indices), _samples(ds.dataset))
    meta = None if ds.metadata is None else list(ds.metadata)
    return list(ds.paths), ds.labels.tolist(), meta


def _rng_logits(n, c, seed):
    return np.random.default_rng(seed).standard_normal((n, c)).astype(np.float32)


def _hook_inputs(ours, ref):
    """Seeded inputs for every hook ``ref`` has: {hook: [args, ...]}."""
    rng = np.random.default_rng(3)
    out = {}
    if hasattr(ref, "project_logits"):
        width = len(ref.classnames)
        out["project_logits"] = [(_rng_logits(6, 1000, 1),), (_rng_logits(5, width, 2),)]
    if hasattr(ref, "scatter_weights"):
        out["scatter_weights"] = [(_rng_logits(4, len(ref.classnames), 4),), (_rng_logits(2, 1000, 5),)]
    if hasattr(ref, "project_labels"):
        if hasattr(ref, "class_idx_map"):
            domain = sorted(ref.class_idx_map)
        elif hasattr(ref, "CLASS_IDX_MAP"):
            domain = sorted(ref.CLASS_IDX_MAP)
        else:
            ref.get_test_indices()
            ours.get_test_indices()
            domain = list(ref.class_sublist)
        out["project_labels"] = [(rng.choice(domain, 9),)]
    if hasattr(ref, "accuracy"):
        out["accuracy"] = [(_rng_logits(7, 113, 6), rng.integers(0, 113, 7), None, None)]
    if hasattr(ref, "post_loop_metrics"):
        if hasattr(ref, "pmsets"):
            if hasattr(ref, "score_predictions"):
                keys = sorted(ref.label_map)
                paths = [f"/data/x/{k}" for k in keys]
                out["post_loop_metrics"] = [(None, _rng_logits(len(keys), 30, 7), paths, None)]
            else:
                out["post_loop_metrics"] = [(rng.integers(0, 30, 8), _rng_logits(8, 30, 8), None, None)]
        else:
            c = len(ref.classnames)
            labels = rng.integers(0, c, 12)
            logits = _rng_logits(12, c, 9)
            logits[np.arange(6), labels[:6]] += 10  # half right
            regions = np.asarray(["Asia", "Europe", "Other", "Africa"] * 3)
            out["post_loop_metrics"] = [(labels, logits, regions, None)]
    return out


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert type(got) is type(want) and got == want, (got, want)


# (dataset name, tree, keyword arguments)
CASES = [
    ("ImageNet", "main", {}),
    ("ImageNet", "valdirs", {}),
    ("ImageNetTrain", "main", {}),
    ("ImageNet1", "main", {}),
    ("ImageNetKShot", "main", {"k": 2}),
    ("ImageNetV2", "main", {}),
    ("ImageNetSketch", "main", {}),
    ("ImageNetR", "main", {}),
    ("ImageNetA", "main", {}),
    ("ImageNetRValClasses", "main", {}),
    ("ImageNetAValClasses", "main", {}),
    ("ObjectNet", "main", {}),
    ("ObjectNetValClasses", "main", {}),
    ("ImageNetVidRobust", "main", {}),
    ("ImageNetVidRobust", "main", {"positional": True}),
    ("ImageNetVidRobustValClasses", "main", {}),
    ("IWildCam", "main", {}),
    ("IWildCamOOD", "main", {}),
    ("IWildCamID", "main", {}),
    ("IWildCamIDVal", "main", {}),
    ("IWildCam", "main", {"subset": "test"}),
    ("IWildCamNonEmpty", "main", {}),
    ("IWildCamOODNonEmpty", "main", {}),
    ("IWildCamIDNonEmpty", "main", {}),
    ("FMOW", "main", {}),
    ("FMOWOOD", "main", {}),
    ("FMOWID", "main", {}),
    ("FMOWIDVal", "main", {}),
    ("FMOWOOD", "fmow_mapping", {}),
    ("FMOWOOD", "fmow_codes", {}),
    ("Caltech101Test", "main", {}),
    ("Caltech101Val", "main", {}),
    ("Caltech101Train", "main", {}),
    ("PatchCamelyonTest", "main", {"k": 4}),
    ("sst2Val", "main", {"k": 4}),
    ("SST2Train", "main", {}),
    ("OxfordPet", "main", {}),
    ("OxfordPetVal", "main", {}),
]

# The ValClasses suites index 50 images a class of the full ImageNet val
# set, which these trees do not hold: their loaders are built, not read.
_INDEXED = ("ImageNetRValClasses", "ImageNetAValClasses", "ObjectNetValClasses", "ImageNetVidRobustValClasses")


@pytest.mark.parametrize("name, tree, kw", CASES, ids=[f"{n}-{t}-{'-'.join(k)}" for n, t, k in CASES])
def test_dataset_matches_jax(trees, name, tree, kw):
    ref, ours = make_pair(name, trees[tree], **kw)
    assert type(ours).__name__ == type(ref).__name__
    assert ours.classnames == ref.classnames
    for attr in ("class_sublist_mask", "rev_class_idx_map", "class_idx_map", "CLASS_IDX_LIST", "CLASS_IDX_MAP",
                 "index_cat", "index_dog", "class_cat", "merge_op", "remove_non_empty", "k"):
        if hasattr(ref, attr) and not callable(getattr(ref, attr)):
            assert getattr(ours, attr) == getattr(ref, attr), attr
    assert _samples(ours.test_dataset) == _samples(ref.test_dataset)
    assert _samples(ours.train_dataset) == _samples(ref.train_dataset)
    if ref.test_loader is not None:
        assert len(ours.test_loader) == len(ref.test_loader)
        assert ours.test_loader.shuffle is False and ours.test_loader.drop_last is False
        assert ours.test_loader.shard_by_process is False
        if name in _INDEXED:
            assert ours.get_test_indices() == ref.get_test_indices()
        else:
            got, want = list(ours.test_loader), list(ref.test_loader)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert_batches_equal(g, w)
    if ref.train_loader is not None:
        assert_batches_equal(next(iter(ours.train_loader)), next(iter(ref.train_loader)))
    for hook, calls in _hook_inputs(ours, ref).items():
        for args in calls:
            _assert_same(getattr(ours, hook)(*args), getattr(ref, hook)(*args))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_fmow_warns_without_the_mapping(trees):
    records = _Records()
    logging.getLogger("flyp_tpu_torch").addHandler(records)
    try:
        _, ours = make_pair("FMOWOOD", trees["fmow_codes"])
    finally:
        logging.getLogger("flyp_tpu_torch").removeHandler(records)
    assert any("country_code_mapping.csv not found" in m for m in records.messages)
    assert set(ours.test_dataset.metadata) == {"Other"}


def test_fmow_refuses_an_unknown_split_and_category(trees, tmp_path):
    _, ours = make_pair("FMOWOOD", trees["main"])
    with pytest.raises(ValueError, match="unknown fmow split"):
        ours._load_split("nope")
    d = tmp_path / "fmow_v1.1"
    os.makedirs(d / "images")
    pd.DataFrame([{"split": "test", "timestamp": "2017-01-01T00:00:00Z", "category": "spaceport",
                   "region": "Asia"}]).to_csv(d / "rgb_metadata.csv", index=False)
    for reg in (jax_registry, port_registry):
        with pytest.raises(ValueError, match="spaceport"):
            reg.get_dataset_class("FMOWOOD")(location=str(tmp_path), batch_size=2, num_workers=1)


def _public_names(module):
    return sorted(n for n in dir(module) if not n.startswith("_") and isinstance(getattr(module, n), type))


def test_get_dataset_class_matches_jax():
    names = _public_names(jax_datasets)
    assert _public_names(port_datasets) == names
    assert "ImageNet16" in names and "ImageNet600" in names
    for name in names + ["sst2Val", "sst2Test", "sst2Train"]:
        ours, ref = port_registry.get_dataset_class(name), jax_registry.get_dataset_class(name)
        assert ours.__name__ == ref.__name__, name
        assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in ref.__mro__], name
        assert ours.__module__.replace("flyp_tpu_torch.", "flyp_tpu.") == ref.__module__, name
    assert port_datasets.ImageNet8.k(None) == 8 and port_datasets.ImageNet600.k(None) == 600
    for reg in (jax_registry, port_registry):
        with pytest.raises(KeyError, match="unknown dataset 'NoSuchSet'; known: .*ImageNetV2"):
            reg.get_dataset_class("NoSuchSet")


def test_get_classnames_for_matches_jax(tmp_path):
    cfg = SimpleNamespace(data_location=str(tmp_path))
    for name in _public_names(jax_datasets) + ["sst2Val", "ImageNetAll", "NoSuchSet"]:
        try:
            want = jax_registry.get_classnames_for(name, cfg)
        except KeyError as e:
            with pytest.raises(KeyError) as got:
                port_registry.get_classnames_for(name, cfg)
            assert str(got.value) == str(e), name
            continue
        assert port_registry.get_classnames_for(name, cfg) == want, name
        assert port_registry.get_classnames_for(name) == want, name
    assert len(port_registry.get_classnames_for("ObjectNet")) == 113


def test_objectnet_metadata_is_a_byte_copy():
    ours = REPO / "flyp_tpu_torch" / "data" / "metadata" / "objectnet"
    ref = REPO / "flyp_tpu" / "data" / "metadata" / "objectnet"
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names and len(names) == 4
    for n in names:
        assert (ours / n).read_bytes() == (ref / n).read_bytes(), n


def test_package_data_ships_the_metadata():
    """An installed (non-editable) port reads labels.csv and the ObjectNet
    files: pyproject ships ``data/metadata/*/*``, and the CLI is a script."""
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        project = tomllib.load(f)
    globs = project["tool"]["setuptools"]["package-data"]["flyp_tpu_torch.data"]
    shipped = {str(p.relative_to(REPO / "flyp_tpu_torch" / "data"))
               for g in globs for p in (REPO / "flyp_tpu_torch" / "data").glob(g)}
    assert {"metadata/iwildcam/labels.csv", "metadata/objectnet/folder_to_objectnet_label.json",
            "metadata/objectnet/imagenet_to_label_2012_v2", "metadata/objectnet/objectnet_to_imagenet_1k.json",
            "metadata/objectnet/pytorch_to_imagenet_2012_id.json"} <= shipped
    assert project["project"]["scripts"]["flyp-zeroshot-eval-torch"] == "flyp_tpu_torch.cli.zeroshot_eval:main"


def test_label_flip_noise_matches_jax(trees):
    from flyp_tpu.data.datasets.base import ImageFolderDataset as JaxFolder
    from flyp_tpu_torch.data.datasets.base import ImageFolderDataset as PortFolder

    root = os.path.join(trees["main"], "ILSVRC2012", "train")
    for p, seed in ((0.5, 0), (0.9, 3)):
        ref = JaxFolder.from_root(root, None, flip_label_prob=p, num_classes=1000, seed=seed)
        ours = PortFolder.from_root(root, None, flip_label_prob=p, num_classes=1000, seed=seed)
        assert ours.samples == ref.samples
        assert ours.samples != PortFolder.from_root(root, None).samples


def test_scan_image_folder_matches_jax(trees):
    from flyp_tpu.data.datasets.base import IMG_EXTENSIONS as jax_exts, scan_image_folder as jax_scan
    from flyp_tpu_torch.data.datasets.base import IMG_EXTENSIONS, scan_image_folder

    assert IMG_EXTENSIONS == jax_exts
    for sub in ("ILSVRC2012/val", "objectnet-1.0/images", "imagenet_vid_ytbb_robust/imagenet-vid-robust/val"):
        root = os.path.join(trees["main"], sub)
        assert scan_image_folder(root) == jax_scan(root)


def test_npy_sources_and_the_native_hook(trees, tmp_path):
    """A ``.npy`` source goes through Pillow even when the transform has the
    native ``from_path`` hook; other files go to the hook."""
    from flyp_tpu.data.datasets.base import ImageFolderDataset as JaxFolder
    from flyp_tpu_torch.data.datasets.base import ImageFolderDataset as PortFolder

    arr = np.random.default_rng(0).integers(0, 255, (18, 21, 3), dtype=np.uint8)
    np.save(tmp_path / "a.npy", arr)
    calls = []

    class Hooked:
        def __init__(self, tf):
            self.tf = tf

        def __call__(self, img, rng=None):
            return self.tf(img, rng)

        def from_path(self, path, rng):
            calls.append(path)
            return np.zeros((PX, PX, 3), np.float64)

    samples = [(str(tmp_path / "a.npy"), 3), (os.path.join(trees["main"], "sketch", "n00", "0.png"), 1)]
    got = [PortFolder(samples, Hooked(port_eval_transform(PX))).get(i, np.random.default_rng(0)) for i in (0, 1)]
    want = [JaxFolder(samples, Hooked(jax_eval_transform(PX))).get(i, np.random.default_rng(0)) for i in (0, 1)]
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    assert got[1]["image"].dtype == np.float32 and calls == [samples[1][0]] * 2
