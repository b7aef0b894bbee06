"""The port's evaluation harness against the JAX package's, on the CPU.

* ``evaluate`` and ``eval_single_dataset`` of both packages on the same
  synthetic trees (``tests/test_torch_eval_datasets.py``) with the same
  duck-typed numpy classifier, which reads the class it predicts from an
  image's flat colour: every hook (``project_logits``, ``project_labels``,
  OxfordPet's ``index_cat``, a custom ``accuracy``, ``post_loop_metrics``,
  ``excluded_indices``), ``--self_data`` and the progress eval over a
  guidance CSV.  ``train_stats`` must be equal, values and key order.
* ``eval_single_batch``, ``process_train_stat``, ``per_class_tally``.
* The real classifiers: a tiny CLIP built from JAX params (the port's
  through ``from_jax_params``), zero-shot heads from ``build_zeroshot_head``,
  over class-coloured images; logits to 1e-4 x (1 + max|logit|) in fp32,
  and equal metrics where no top-1/top-2 margin is under 1e-3.
* ``cli/zeroshot_eval.main`` of both packages on one tiny ``.pt``.
* ``get_features`` (a hit makes no call; the ``.npz`` equals JAX's),
  ``lagged_device_method``, ``get_logger`` and ``cli/serve.py``'s
  ``--data-location``.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from __graft_entry__ import _tiny_config
from flyp_tpu.cli import serve as jax_serve
from flyp_tpu.cli import zeroshot_eval as jax_zeroshot_eval
from flyp_tpu.config import ExperimentConfig as JaxConfig
from flyp_tpu.data import csv_data as jax_csv_data
from flyp_tpu.data import datasets as jax_datasets
from flyp_tpu.data import registry as jax_registry
from flyp_tpu.evaluation import Classifier as JaxClassifier
from flyp_tpu.evaluation import evaluator as jax_evaluator
from flyp_tpu.evaluation import features as jax_features
from flyp_tpu.evaluation import metrics as jax_metrics
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.models.convert import export_clip_state_dict, save_torch_checkpoint
from flyp_tpu.training import flyp as jax_flyp
from flyp_tpu_torch.cli import serve as port_serve
from flyp_tpu_torch.cli import zeroshot_eval
from flyp_tpu_torch.config import ExperimentConfig
from flyp_tpu_torch.data import csv_data
from flyp_tpu_torch.data import datasets as port_datasets
from flyp_tpu_torch.data import registry as port_registry
from flyp_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from flyp_tpu_torch.evaluation import Classifier, evaluator, features, metrics
from flyp_tpu_torch.models import CLIPModel, convert
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.parallel import multihost
from flyp_tpu_torch.training import flyp
from flyp_tpu_torch.utils.logging import get_logger
from flyp_tpu_torch.utils.pipeline import lagged_device_method
from tests.test_torch_eval_datasets import LEVELS, PREDICT, PX, STEP, save_image, write_trees

torch.set_num_threads(1)


class SlotClassifier:
    """Duck-typed classifier: reads each image's slot from its flat colour
    and predicts ``PREDICT[slot]`` (mod ``num_classes``) with logit 5; the
    other columns are small seeded noise of the slot."""

    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.model = SimpleNamespace(config=SimpleNamespace(vision=SimpleNamespace(image_size=PX)))
        self.calls = 0

    def predict_logits(self, images):
        self.calls += 1
        v = (np.asarray(images, np.float64) * CLIP_STD + CLIP_MEAN) * 255.0
        levels = np.rint(v.mean(axis=(1, 2)) / STEP).astype(int)
        slots = levels[:, 0] * LEVELS ** 2 + levels[:, 1] * LEVELS + levels[:, 2]
        out = np.stack([np.random.default_rng(int(s)).normal(0, 0.1, self.num_classes) for s in slots])
        out[np.arange(len(slots)), [PREDICT[int(s)] % self.num_classes for s in slots]] = 5.0
        return out.astype(np.float32)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    roots = write_trees(str(tmp_path_factory.mktemp("eval_trees")))
    # A guidance CSV over class-slot images: label 0-4, three guidance levels.
    csv_root = os.path.join(roots["main"], "csv")
    rows = ["filepath\ttitle\tlabel\tguidance"]
    for i in range(23):
        label = i % 5
        path = os.path.join(csv_root, f"{i}.png")
        save_image(path, label if i % 3 else (label + i) % 5)
        rows.append(f"{path}\ta photo\t{label}\t{(100, 50, 20)[i % 3]}")
    roots["csv"] = os.path.join(csv_root, "test.tsv")
    with open(roots["csv"], "w") as f:
        f.write("\n".join(rows) + "\n")
    return roots


def _cfgs(location, **kw):
    base = dict(data_location=location, batch_size=4, workers=1, **kw)
    return JaxConfig(**base), ExperimentConfig(**base)


def _toy_datasets(datasets):
    """Hook-only test datasets for one package: ``project_labels`` (a label
    permutation) on ImageNet's tree, ``excluded_indices`` on iWildCam's."""

    class ToyLabels(datasets.ImageNet):
        def populate_train(self):
            self.train_dataset = None
            self.train_loader = None

        def project_labels(self, labels):
            return (np.asarray(labels) * 2 + 1) % 3

    class ToyExcluded(datasets.IWildCamOOD):
        excluded_indices = [0, 3]

    return {"ToyLabels": ToyLabels, "ToyExcluded": ToyExcluded}


@pytest.fixture
def toys(monkeypatch):
    for datasets in (jax_datasets, port_datasets):  # registered in both, by name
        for name, cls in _toy_datasets(datasets).items():
            monkeypatch.setattr(datasets, name, cls, raising=False)


# (eval datasets, classifier width, tree)
EVAL_CASES = [
    (["ImageNet"], 1000, "main"),
    (["ImageNet", "ImageNetV2", "ImageNetSketch"], 1000, "main"),
    (["ImageNet"], 1000, "valdirs"),
    (["ImageNetR", "ImageNetA"], 1000, "main"),
    (["ObjectNet"], 1000, "main"),
    (["ImageNetVidRobust"], 1000, "main"),
    (["IWildCamOOD", "IWildCamOODNonEmpty"], 182, "main"),
    (["FMOWOOD"], 62, "main"),
    (["FMOWOOD"], 62, "fmow_mapping"),
    (["OxfordPet"], 4, "main"),
    (["Caltech101Test", "sst2Val"], 101, "main"),
    (["ToyLabels"], 1000, "main"),
    (["ToyExcluded"], 182, "main"),
]


@pytest.mark.parametrize("names, width, tree", EVAL_CASES, ids=["+".join(c[0]) + "-" + c[2] for c in EVAL_CASES])
def test_evaluate_matches_jax(trees, toys, names, width, tree):
    jcfg, cfg = _cfgs(trees[tree], eval_datasets=names)
    want = jax_evaluator.evaluate(SlotClassifier(width), jcfg, {"earlier": 1.0})
    got = evaluator.evaluate(SlotClassifier(width), cfg, {"earlier": 1.0})
    assert list(got) == list(want) and len(want) >= 2
    assert got == want
    for k in want:
        assert type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("name, width", [("ObjectNet", 1000), ("ImageNetR", 1000), ("IWildCamOOD", 182),
                                         ("FMOWOOD", 62), ("ImageNetVidRobust", 1000), ("OxfordPet", 4),
                                         ("ToyLabels", 1000), ("ToyExcluded", 182)])
@pytest.mark.parametrize("self_data", [False, True])
def test_eval_single_dataset_matches_jax(trees, toys, name, width, self_data):
    """The whole metrics dict, every hook; ``self_data`` takes precedence
    over ``post_loop_metrics``."""
    jcfg, cfg = _cfgs(trees["main"], self_data=self_data)
    kw = dict(location=trees["main"], batch_size=3, num_workers=1)
    from flyp_tpu.data.transforms import eval_transform as jax_tf
    from flyp_tpu_torch.data.transforms import eval_transform as port_tf

    ref = jax_registry.get_dataset_class(name)(preprocess=jax_tf(PX), **kw)
    ours = port_registry.get_dataset_class(name)(preprocess=port_tf(PX), **kw)
    want = jax_evaluator.eval_single_dataset(SlotClassifier(width), ref, jcfg)
    got = evaluator.eval_single_dataset(SlotClassifier(width), ours, cfg)
    assert list(got) == list(want)
    assert got == want
    if self_data and hasattr(ours, "post_loop_metrics"):
        assert set(got) <= {"acc", "top1", "class_top1"}


def test_self_data_and_progress_eval_match_jax(trees):
    """``--self_data`` reads ``ft_data_test`` through the CSV loader; the
    progress eval scores each guidance level (accuracy, count, macro F1)."""
    jcfg, cfg = _cfgs(trees["main"], eval_datasets=["IWildCamOOD", "Mine"], self_data=True,
                      ft_data_test=trees["csv"])
    want = jax_evaluator.evaluate(SlotClassifier(5), jcfg)
    got = evaluator.evaluate(SlotClassifier(5), cfg)
    assert list(got) == list(want) and got == want and "Mine Class 4 Number" in got

    jcfg, cfg = _cfgs(trees["main"], eval_datasets=[], ft_data_test=trees["csv"])
    jdata = jax_csv_data.get_csv_loader(jcfg, is_train=False, image_size=PX, return_guidance=True)
    data = csv_data.get_csv_loader(cfg, is_train=False, image_size=PX, return_guidance=True)
    want = jax_evaluator.evaluate(SlotClassifier(5), jcfg, {}, progress_eval=True, eval_batch_loader=jdata)
    got = evaluator.evaluate(SlotClassifier(5), cfg, {}, progress_eval=True, eval_batch_loader=data)
    assert list(got) == list(want) and got == want
    assert {"Guidance 20 F1", "Guidance 50 Accuracy", "Guidance 100 Number"} <= set(got)
    assert evaluator.evaluate(SlotClassifier(5), ExperimentConfig()) is None


@pytest.mark.parametrize("name, width", [("ImageNet", 1000), ("ImageNetR", 1000), ("ObjectNet", 1000)])
def test_eval_single_batch_matches_jax(trees, name, width):
    from flyp_tpu.data.transforms import eval_transform as jax_tf
    from flyp_tpu_torch.data.transforms import eval_transform as port_tf

    kw = dict(location=trees["main"], batch_size=5, num_workers=1)
    ref = jax_registry.get_dataset_class(name)(preprocess=jax_tf(PX), **kw)
    ours = port_registry.get_dataset_class(name)(preprocess=port_tf(PX), **kw)
    batch = next(iter(ours.test_loader))
    jtop1, jce = jax_evaluator.eval_single_batch(SlotClassifier(width), ref, None, batch)
    top1, ce = evaluator.eval_single_batch(SlotClassifier(width), ours, None, batch)
    assert top1 == jtop1
    assert abs(ce - jce) <= 1e-6 and np.isfinite(ce)


def test_process_train_stat_and_per_class_tally_match_jax():
    rng = np.random.default_rng(4)
    results = {"top1": 0.5, "acc_worst_region": rng.random(), "F1-macro_all": rng.random(), "pm0": rng.random(),
               "pm10": 0.25, "guidance_f1": 0.3, "acc_region:Asia": 0.1, "f1_other": np.float32(0.123456)}
    for name in ("", "IWildCamOOD"):
        want, got = {"x": 1}, {"x": 1}
        jax_evaluator.process_train_stat(results, want, None, name)
        evaluator.process_train_stat(results, got, get_logger(None, "test_torch_eval"), name)
        assert list(got) == list(want) and got == want
    want, got = {}, {}
    for b in range(4):
        labels = rng.integers(0, 9, 17)
        preds = np.where(rng.random(17) < 0.5, labels, rng.integers(0, 9, 17))
        assert jax_metrics.per_class_tally(preds, labels, want) is want
        assert metrics.per_class_tally(preds, labels, got) is got
    assert list(got) == list(want) and got == want


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny CLIP (64 px, real tokenizer) in both packages from the same
    JAX params, and the ``.pt`` the JAX converter writes of it."""
    jcfg = _tiny_config(real_text=True)
    jmodel = JaxCLIPModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jmodel, 3))
    model = CLIPModel(port_config(jcfg))
    model.load_state_dict(convert.from_jax_params(params), strict=True)
    model.eval().requires_grad_(False)
    ckpt = str(tmp_path_factory.mktemp("tiny") / "tiny.pt")
    save_torch_checkpoint(ckpt, export_clip_state_dict(params))
    return SimpleNamespace(jcfg=jcfg, jmodel=jmodel, variables={"params": params}, model=model, ckpt=ckpt)


@pytest.fixture(scope="module")
def coloured(tmp_path_factory):
    """ImageNet-R's tree of class-coloured images: 6 folders of 3 images,
    each folder its own hue."""
    root = tmp_path_factory.mktemp("coloured")
    rng = np.random.default_rng(7)
    for k in range(6):
        hue = rng.integers(0, 255, 3)
        for i in range(3):
            img = np.clip(hue + rng.integers(-30, 30, (70, 80, 3)), 0, 255).astype(np.uint8)
            path = root / "imagenet-r" / f"c{k}" / f"{i}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(path)
    return str(root)


def test_classifiers_on_coloured_images_match_jax(tiny, coloured):
    """The real classifiers, zero-shot heads from ``build_zeroshot_head``
    (ImageNet-R's 200 classes, one template), fp32."""
    base = dict(train_dataset="ImageNetR", template="simple_template", eval_datasets=["ImageNetR"],
                data_location=coloured, batch_size=8, workers=1, compute_dtype="float32")
    jcfg, cfg = JaxConfig(**base), ExperimentConfig(**base)
    jhead = jax_flyp.build_zeroshot_head(jcfg, tiny.jmodel, tiny.variables)
    head = flyp.build_zeroshot_head(cfg, tiny.model)
    np.testing.assert_allclose(head.weight.numpy(), np.asarray(jhead.weight), atol=1e-4, rtol=1e-4)
    jclf = JaxClassifier(tiny.jmodel, tiny.variables, jhead, batch_size=8)
    clf = Classifier(tiny.model, head, batch_size=8)

    from flyp_tpu_torch.data.transforms import eval_transform

    ds = port_datasets.ImageNetR(preprocess=eval_transform(64), location=coloured, batch_size=8, num_workers=1)
    margins = []
    for batch in ds.test_loader:
        want = np.asarray(jclf.predict_logits(batch["image"]))
        got = clf.predict_logits(batch["image"])
        assert got.dtype == np.float32 and got.shape == want.shape == (len(batch["label"]), 200)
        np.testing.assert_allclose(got, want, atol=1e-4 * (1 + np.abs(want).max()), rtol=0)
        top2 = np.sort(want, axis=1)[:, -2:]
        margins.extend(top2[:, 1] - top2[:, 0])
        feats, jfeats = clf.features(batch["image"]), np.asarray(jclf.features(batch["image"]))
        np.testing.assert_allclose(feats, jfeats, atol=1e-4 * (1 + np.abs(jfeats).max()), rtol=0)
    assert min(margins) > 1e-3, min(margins)
    want = jax_evaluator.evaluate(jclf, jcfg)
    got = evaluator.evaluate(clf, cfg)
    assert list(got) == list(want) and got == want and "ImageNetR Class 5 Accuracy" in got
    jfeat = jax_features.extract_loader_features(jclf, ds.test_loader, with_paths=True)
    feat = features.extract_loader_features(clf, ds.test_loader, with_paths=True)
    np.testing.assert_allclose(feat["features"], jfeat["features"], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(feat["labels"], jfeat["labels"])
    np.testing.assert_array_equal(feat["paths"], jfeat["paths"])


def test_zeroshot_classnames_match_jax():
    for self_data, name in ((True, None), (False, "ObjectNet"), (False, "IWildCamOOD"), (False, "FMOWOOD")):
        jcfg, cfg = JaxConfig(self_data=self_data, train_dataset=name), ExperimentConfig(
            self_data=self_data, train_dataset=name)
        assert flyp._resolve_zeroshot_classnames(cfg) == jax_flyp._resolve_zeroshot_classnames(jcfg)


@pytest.mark.parametrize("train_dataset, template", [("IWildCamOOD", "iwildcam_template"),
                                                     ("ImageNetR", "simple_template")])
def test_zeroshot_eval_cli_matches_jax(trees, tiny, tmp_path, train_dataset, template):
    base = dict(clip_load=tiny.ckpt, model="ViT-B/16", compute_dtype="float32", train_dataset=train_dataset,
                template=template, eval_datasets=[train_dataset], data_location=trees["main"], batch_size=4,
                workers=1)
    want = jax_zeroshot_eval.main(JaxConfig(log_dir=str(tmp_path / "jax"), **base))
    cfg = ExperimentConfig(log_dir=str(tmp_path / "port"), device="cpu", **base)
    got = zeroshot_eval.main(cfg)
    assert list(got) == list(want) and got == want and len(got) > 3
    with open(tmp_path / "port" / "log.log") as f:
        assert f"{train_dataset} Accuracy: {got[train_dataset + ' Accuracy']}" in f.read()


def test_zeroshot_eval_cli_refusals(tiny, tmp_path):
    orbax_dir = tmp_path / "orbax"
    orbax_dir.mkdir()
    (orbax_dir / "_CHECKPOINT_METADATA").write_text("{}")
    cfg = ExperimentConfig(clip_load=str(orbax_dir), model="ViT-B/16", save=str(tmp_path / "head"), device="cpu",
                           log_dir=str(tmp_path / "logs"))
    with pytest.raises(ValueError, match="tools/export_checkpoint.py"):  # the JAX package's orbax directory
        zeroshot_eval.main(cfg)
    assert not os.path.exists(tmp_path / "head")
    if not torch.cuda.is_available():
        cfg = ExperimentConfig(clip_load=tiny.ckpt, model="ViT-B/16", log_dir=str(tmp_path / "logs"))
        assert cfg.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            zeroshot_eval.main(cfg)


class _Stub:
    def __init__(self):
        batches = [
            {"image": np.zeros((2, 4, 4, 3), np.float32), "label": np.array([0, 1]), "path": ["a", "b"]},
            {"image": np.ones((2, 4, 4, 3), np.float32), "label": np.array([1, 0]), "path": ["c", "d"]},
            {"image": np.full((1, 4, 4, 3), 2, np.float32), "label": np.array([3]), "path": ["e"]},
        ]
        self.train_loader = batches
        self.test_loader = batches[:1]


class _Counting:
    def __init__(self):
        self.calls = 0

    def features(self, images):
        self.calls += 1
        return np.asarray(images).reshape(len(images), -1)[:, :8] * 0.5 + self.calls


def test_feature_cache_matches_jax(tmp_path, monkeypatch):
    ds, jds = _Stub(), _Stub()
    clf, jclf = _Counting(), _Counting()
    out = features.get_features(clf, ds, split="train", cache_dir=str(tmp_path / "port"), with_paths=True)
    ref = jax_features.get_features(jclf, jds, split="train", cache_dir=str(tmp_path / "jax"), with_paths=True)
    assert clf.calls == jclf.calls == 3
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
    npz = tmp_path / "port" / "_Stub" / "train" / "features.npz"
    with np.load(npz) as z, np.load(tmp_path / "jax" / "_Stub" / "train" / "features.npz") as jz:
        assert sorted(z.files) == sorted(jz.files) == ["features", "labels", "paths"]
        for k in jz.files:
            assert z[k].dtype == jz[k].dtype
            np.testing.assert_array_equal(z[k], jz[k])
    assert os.listdir(npz.parent) == ["features.npz"]  # the temporary file was renamed

    again = features.get_features(clf, ds, split="train", cache_dir=str(tmp_path / "port"))
    assert clf.calls == 3  # a hit makes no call
    for k in out:
        np.testing.assert_array_equal(again[k], out[k])
    val = features.get_features(clf, ds, split="val", cache_dir=str(tmp_path / "port"))
    assert clf.calls == 4
    fd = features.FeatureDataset(val)
    assert len(fd) == 2 and fd[1]["labels"] == 1 and fd[0]["features"].shape == (8,)

    monkeypatch.setattr(multihost, "is_primary", lambda: False)
    features.get_features(clf, ds, split="test", cache_dir=str(tmp_path / "port"))
    assert clf.calls == 5 and not os.path.exists(tmp_path / "port" / "_Stub" / "test")
    uncached = features.get_features(clf, ds, split="train")
    assert clf.calls == 8 and "paths" not in uncached


def test_lagged_device_method_takes_both_handles(trees):
    class Device:
        def predict_logits_device(self, images):
            t = torch.arange(24, dtype=torch.float32).reshape(6, 4).to(torch.bfloat16) / 7
            return t, len(images)

    dispatch, fetch = lagged_device_method(Device(), "predict_logits_device", "predict_logits")
    handle = dispatch(np.zeros((4, 2, 2, 3)))
    out = fetch(handle)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32 and out.shape == (4, 4)
    np.testing.assert_array_equal(out, handle[0][:4].float().numpy())

    clf = SlotClassifier(3)
    dispatch, fetch = lagged_device_method(clf, "predict_logits_device", "predict_logits")
    images = next(iter(port_datasets.ImageNetSketch(location=trees["main"], batch_size=2,
                                                    num_workers=1).test_loader))["image"]
    handle = dispatch(images)
    assert handle[1] is None and clf.calls == 1  # the synchronous fallback
    np.testing.assert_array_equal(fetch(handle), clf.predict_logits(images))


def test_get_logger_writes_stdout_and_file(tmp_path, capsys):
    log = get_logger(str(tmp_path / "logs"), name="test_torch_eval_logger")
    log.info("hello %d", 3)
    log = get_logger(str(tmp_path / "logs"), name="test_torch_eval_logger")  # handlers replaced, not added
    log.info("again")
    for h in log.handlers:
        h.flush()
    assert len(log.handlers) == 2 and not log.propagate
    text = (tmp_path / "logs" / "log.log").read_text()
    assert "[INFO] hello 3" in text and "[INFO] again" in text
    assert capsys.readouterr().out.count("again") == 1


def test_serve_takes_data_location(tmp_path):
    argv = ["--checkpoint", "x.pt", "--images", "a.png", "--train-dataset", "ObjectNet", "--data-location",
            str(tmp_path)]
    args, jargs = port_serve.build_parser().parse_args(argv), jax_serve.build_parser().parse_args(argv)
    assert args.data_location == jargs.data_location == str(tmp_path)
    assert port_serve._resolve_classnames(args) == jax_serve._resolve_classnames(jargs)
    assert len(port_serve._resolve_classnames(args)) == 113
    assert port_serve.build_parser().parse_args(argv[:4]).data_location is None
