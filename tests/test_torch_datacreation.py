"""The port's dataset-preparation tools (``flyp_tpu_torch/tools/
datacreation/``) against the JAX package's, on the trees of
``tests/test_datacreation.py``: every file each writes is byte-equal, and
every count it returns equal.
"""

import filecmp
import os
import pickle

import numpy as np
import pandas as pd
import pytest

from flyp_tpu.data.classnames import fmow_classnames
from flyp_tpu.tools.datacreation import fmow_csv as jax_fmow
from flyp_tpu.tools.datacreation import folder_csv as jax_folder
from flyp_tpu.tools.datacreation import iwildcam_csv as jax_iwildcam
from flyp_tpu.tools.datacreation import patchcamelyon_h5 as jax_pcam
from flyp_tpu.tools.datacreation import train_test_split as jax_split
from flyp_tpu_torch.tools.datacreation import fmow_csv, folder_csv, iwildcam_csv, patchcamelyon_h5, train_test_split
from tests.test_datacreation import _folder_tree


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def _same_trees(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.funny_files, (a, b)
    for f in cmp.common_files:
        _same_bytes(os.path.join(a, f), os.path.join(b, f))
    for d in cmp.common_dirs:
        _same_trees(os.path.join(a, d), os.path.join(b, d))


@pytest.mark.parametrize("template, classnames, with_labels", [
    ("patchcamelyon_template", None, True),
    ("simple_template", ["one", "two"], False),
    ("openai_imagenet_template", None, True),
])
def test_folder_csv_matches_jax(tmp_path, template, classnames, with_labels):
    _folder_tree(tmp_path / "tree")
    tree = str(tmp_path / "tree")
    n = folder_csv.build_csv(tree, str(tmp_path / "port.tsv"), template, classnames, with_labels)
    assert n == jax_folder.build_csv(tree, str(tmp_path / "jax.tsv"), template, classnames, with_labels)
    _same_bytes(tmp_path / "port.tsv", tmp_path / "jax.tsv")
    with pytest.raises(AssertionError, match="classnames vs"):
        folder_csv.build_csv(tree, str(tmp_path / "x.tsv"), template, classnames=["only_one"])


def test_folder_csv_cli_matches_jax(tmp_path, capsys):
    """The CLI, with a registered class-name list (``--classnames``)."""
    _folder_tree(tmp_path / "tree", classes=("a", "b"), per_class=2)
    for main, out in ((jax_folder.main, "jax.tsv"), (folder_csv.main, "port.tsv")):
        with pytest.raises(AssertionError):  # 101 names for 2 folders
            main(["--input-folder", str(tmp_path / "tree"), "--output-csv", str(tmp_path / out),
                  "--template", "simple_template", "--classnames", "caltech101_classnames"])
        main(["--input-folder", str(tmp_path / "tree"), "--output-csv", str(tmp_path / out),
              "--template", "simple_template", "--no-labels"])
    _same_bytes(tmp_path / "port.tsv", tmp_path / "jax.tsv")
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("jax.tsv", "X") == out[1].replace("port.tsv", "X")


def test_train_test_split_matches_jax(tmp_path):
    _folder_tree(tmp_path / "flat", classes=("a", "b"), per_class=20)
    flat = str(tmp_path / "flat")
    counts = train_test_split.split_folder(flat, str(tmp_path / "port"), seed=3)
    assert counts == jax_split.split_folder(flat, str(tmp_path / "jax"), seed=3) and sum(counts.values()) == 40
    _same_trees(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "flat" / "a")) == 20  # copied, not moved


def test_patchcamelyon_h5_matches_jax(tmp_path):
    import h5py
    xs = np.arange(6 * 8 * 8 * 3, dtype=np.uint8).reshape(6, 8, 8, 3)
    ys = np.array([0, 1, 0, 1, 1, 0])
    with h5py.File(tmp_path / "x.h5", "w") as f:
        f.create_dataset("x", data=xs)
    with h5py.File(tmp_path / "y.h5", "w") as f:
        f.create_dataset("y", data=ys.reshape(-1, 1, 1, 1))
    for limit in (None, 4):
        args = (str(tmp_path / "x.h5"), str(tmp_path / "y.h5"))
        n = patchcamelyon_h5.convert_split(*args, str(tmp_path / f"port_{limit}" / "train"), limit)
        assert n == jax_pcam.convert_split(*args, str(tmp_path / f"jax_{limit}" / "train"), limit)
        _same_trees(tmp_path / f"port_{limit}", tmp_path / f"jax_{limit}")
    k = patchcamelyon_h5.make_k_shot(str(tmp_path / "port_None" / "train"), str(tmp_path / "port_shot"), 2)
    assert k == jax_pcam.make_k_shot(str(tmp_path / "jax_None" / "train"), str(tmp_path / "jax_shot"), 2) == 4
    _same_trees(tmp_path / "port_shot", tmp_path / "jax_shot")


def test_fmow_csv_matches_jax(tmp_path):
    cat_a, cat_b = fmow_classnames[0], fmow_classnames[5]
    meta = pd.DataFrame({
        "split": ["train", "train", "seq", "val", "train"],
        "timestamp": ["2010-03-01T12:00:00Z", "2014-06-01T12:00:00Z", "2010-01-01T00:00:00Z",
                      "2011-01-01T00:00:00Z", "2012-12-31T23:59:59Z"],
        "category": [cat_a, cat_a, cat_a, cat_a, cat_b],
    })
    root = tmp_path / "fmow_v1.1"
    root.mkdir()
    meta.to_csv(root / "rgb_metadata.csv", index=False)
    n = fmow_csv.build_csv(str(root), str(tmp_path / "port.tsv"))
    assert n == jax_fmow.build_csv(str(root), str(tmp_path / "jax.tsv")) > 0
    _same_bytes(tmp_path / "port.tsv", tmp_path / "jax.tsv")


def test_iwildcam_csv_matches_jax(tmp_path):
    from PIL import Image

    labels = tmp_path / "labels.csv"
    pd.DataFrame({"name": ["red fox", "meerkat", "empty"], "english": ["red fox", "meerkat", "empty"],
                  "y": [3, 7, 99999]}).to_csv(labels, index=False)
    root = tmp_path / "crops"
    for p in ("red_fox/a.jpg", "red_fox/b.jpg", "red_fox/Strength30_aug/a.jpg", "red_fox/Strength60_aug/a.jpg",
              "red_fox/Strength60_aug/c.jpg", "meerkat/m.jpg"):
        (root / p).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(root / p)
    (root / "unknown_species").mkdir()
    fp = tmp_path / "filter.pkl"
    with open(fp, "wb") as f:
        pickle.dump({"Strength30_aug": {"red_fox": ["a"]}, "Strength60_aug": {"red_fox": []}}, f)
    for kw in (dict(strength_folders=True), dict(strength_folders=True, clip_filter=str(fp)), dict(mode="test")):
        df = iwildcam_csv.collect_rows(str(root), str(labels), **kw)
        want = jax_iwildcam.collect_rows(str(root), str(labels), **kw)
        pd.testing.assert_frame_equal(df, want)
        n = iwildcam_csv.write_csv(df, str(labels), str(tmp_path / "port.tsv"))
        assert n == jax_iwildcam.write_csv(want, str(labels), str(tmp_path / "jax.tsv")) == len(df) > 0
        _same_bytes(tmp_path / "port.tsv", tmp_path / "jax.tsv")
    for main, out in ((jax_iwildcam.main, "jax_cli.tsv"), (iwildcam_csv.main, "port_cli.tsv")):
        main(["--input-folder", str(root), "--labels-csv", str(labels), "--output-csv", str(tmp_path / out),
              "--strength-folders", "--clip-filter", str(fp)])
    _same_bytes(tmp_path / "port_cli.tsv", tmp_path / "jax_cli.tsv")
