"""The port's FLYP trainer (``flyp_tpu_torch/training/flyp.py``) against the
JAX package's ``flyp_train``.

Both trainers start from one tiny CLIP (``tests/test_flyp_trainer.py::
tiny_model``'s sizes; the JAX params cross by ``from_jax_params``) and run 2
epochs on the corpus of ``tests/test_flyp_trainer.py`` (two classes, guidance
2 and 100, batch 8), under ``--baseline``, ``--curriculum`` and
``--curriculum_epoch 1`` with the ``drestart`` schedule and
``--proportion``; each JAX run happens once per module and its artifacts
are shared.  JAX runs its
``xla`` route on the CPU, the port its default route's plain versions; both
compute in fp32.  Tolerances: the step-0 loss to 1e-5; each learning rate
equal to JAX's schedule and within one fp32 ulp of the rate JAX's jitted
step logged, plus half the base rate times the cosine's ulp; the parameters after 2 epochs within twice the summed
rates (Adam's first steps move each parameter by about the rate, so
sub-ulp differences can flip a step's sign); each accuracy within one of
the 16 evaluation images.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp
import pandas as pd
import pytest
import torch

from flyp_tpu.config import ExperimentConfig as JaxConfig
from flyp_tpu.training import curriculum as jax_curriculum
from flyp_tpu.training import flyp as jax_flyp
from flyp_tpu.training.schedules import make_scheduler as jax_make_scheduler
from flyp_tpu_torch.config import ExperimentConfig
from flyp_tpu_torch.models import CLIPModel, convert
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.ops import attention as port_attention
from flyp_tpu_torch.ops.losses import clip_loss
from flyp_tpu_torch.training import curriculum, flyp
from flyp_tpu_torch.training.kmeans import kmeans
from flyp_tpu_torch.utils import checkpoint
from tests.test_flyp_trainer import corpus, tiny_model  # noqa: F401

torch.set_num_threads(1)

# Each variant's flags and its steps an epoch: --baseline trains on the 16
# guidance-100 rows, --curriculum walks guidance 2 then 100 (32 rows), and
# --curriculum_epoch 1 trains guidance 2 for the budget of the 16 original
# rows, then restarts the schedule (drestart) and the loader on guidance 100,
# with --proportion mixing.
VARIANTS = {"baseline": (dict(baseline=True), 2), "curriculum": (dict(curriculum=True), 4),
            "curriculum_epoch": (dict(curriculum=True, curriculum_epoch=1, scheduler="drestart", proportion=True), 2)}
EVAL_IMAGES = 16  # PatchCamelyonVal in the corpus: 2 classes x 8


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


def _fields(corpus, root, name, **overrides):  # noqa: F811
    d = dict(train_dataset="PatchCamelyonVal", template="patchcamelyon_template", eval_datasets=["PatchCamelyonVal"],
             data_location=corpus["root"], ft_data=corpus["train_csv"], ft_data_test=corpus["train_csv"],
             batch_size=8, lr=1e-3, wd=0.1, warmup_length=2, epochs=2, workers=2, debug=False,
             compute_dtype="float32", seed=0, log_dir=str(root / name / "logs"), save=str(root / name / "ckpt"))
    d.update(overrides)
    return d


def port_cfg(corpus, root, name, **overrides):  # noqa: F811
    return ExperimentConfig(device="cpu", **_fields(corpus, root, name, **overrides))


def port_model():
    jmodel, variables = tiny_model()
    model = CLIPModel(port_config(jmodel.config))
    model.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, variables["params"])))
    return model


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):  # noqa: F811
    """Each variant run once by each trainer: their config and return value."""
    root = tmp_path_factory.mktemp("trainers")
    out = {}
    for name, (flags, _) in VARIANTS.items():
        jcfg = JaxConfig(**_fields(corpus, root, f"jax_{name}", **flags))
        jmodel, variables = tiny_model()
        jret = jax_flyp.flyp_train(jcfg, model=jmodel, variables=variables, print_every=2)
        cfg = port_cfg(corpus, root, f"port_{name}", **flags)
        ret = flyp.flyp_train(cfg, model=port_model(), print_every=2)
        out[name] = dict(jax=jcfg, port=cfg, jret=jret, ret=ret)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stats_match_jax(runs, variant):
    r = runs[variant]
    assert os.path.basename(r["ret"]) == os.path.basename(r["jret"]) == "checkpoint_1"
    want = pd.read_csv(os.path.join(r["jax"].log_dir, "stats.tsv"), sep="\t", index_col=0)
    got = pd.read_csv(os.path.join(r["port"].log_dir, "stats.tsv"), sep="\t", index_col=0)
    assert list(got.columns) == list(want.columns) and list(got.index) == list(want.index) == [0, 1]
    assert list(got["Epoch"]) == list(want["Epoch"]) == [0, 1]
    for col in ("PatchCamelyonVal Accuracy", "Avg OOD Acc"):
        np.testing.assert_allclose(got[col], want[col], atol=1 / EVAL_IMAGES + 1e-9, rtol=0)
    np.testing.assert_allclose(got["Avg ID FLYP Loss"], want["Avg ID FLYP Loss"], atol=5e-2, rtol=0)
    for epoch in (0, 1):
        name = f"class_stats{epoch}.tsv"
        want = pd.read_csv(os.path.join(r["jax"].log_dir, name), sep="\t", index_col=0)
        got = pd.read_csv(os.path.join(r["port"].log_dir, name), sep="\t", index_col=0)
        assert list(got.columns) == list(want.columns) == ["PatchCamelyonVal", "PatchCamelyonVal Count"]
        assert sorted(got.index) == sorted(want.index) == ["Class 0", "Class 1"]
        np.testing.assert_array_equal(got.loc[want.index, "PatchCamelyonVal Count"],
                                      want["PatchCamelyonVal Count"])
        # Each class holds 8 of the 16 images: one image is 1/8 of its accuracy.
        np.testing.assert_allclose(got.loc[want.index, "PatchCamelyonVal"], want["PatchCamelyonVal"],
                                   atol=1 / 8 + 1e-9, rtol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_metrics_and_trajectory_match_jax(runs, variant):
    r = runs[variant]
    want, got = _metrics(r["jax"].log_dir), _metrics(r["port"].log_dir)
    assert [list(m) for m in got] == [list(m) for m in want]
    assert [m.get("Image Guidance") for m in got] == [m.get("Image Guidance") for m in want]
    flags, per_epoch = VARIANTS[variant]
    steps = [(g, w) for g, w in zip(got, want) if "ID FLYP Loss" in w]
    assert len(steps) == 2 * per_epoch
    assert steps[0][0]["ID FLYP Loss"] == pytest.approx(steps[0][1]["ID FLYP Loss"], abs=1e-5)
    lr_got = np.array([g["Learning Rate"] for g, _ in steps], np.float32)
    lr_want = np.array([w["Learning Rate"] for _, w in steps], np.float32)
    first = jax_make_scheduler(flags.get("scheduler", "default"), 1e-3, 2, 2, per_epoch)
    # drestart: epoch 1 runs a new schedule of 1 epoch on the kept count.
    second = jax_make_scheduler("default", 1e-3, 2, 1, per_epoch) if "curriculum_epoch" in flags else first
    schedule = [float((first if n < per_epoch else second)(n)) for n in range(len(steps))]
    np.testing.assert_array_equal(lr_got, np.array(schedule, np.float32))
    # JAX's jitted step evaluates the cosine inside a fusion, which can round
    # cos one ulp away from its eager schedule: 0.5 * lr * ulp(1) in the rate.
    assert np.all(np.abs(lr_got - lr_want) <= np.spacing(lr_want) + 0.5 * 1e-3 * np.spacing(np.float32(1)))
    ref = ocp.PyTreeCheckpointer().restore(os.path.abspath(r["jret"]))
    want_params = convert.from_jax_params(ref["params"])
    got_params = checkpoint.load_tensors(r["ret"])
    bound = 2 * float(lr_want.astype(np.float64).sum())
    assert set(got_params) == set(want_params)
    worst = max(float((got_params[k] - want_params[k]).abs().max()) for k in want_params)
    assert worst <= bound, (worst, bound)
    assert checkpoint.read_meta(r["ret"])["step"] == int(ref["step"]) == len(steps)
    assert int(checkpoint.load_tensors(r["ret"], "opt_state.pt")["count"]) == len(steps)


def test_curriculum_functions_match_jax(corpus, tmp_path):  # noqa: F811
    csv = corpus["train_csv"]
    cases = [dict(curriculum=True), dict(curriculum=True, curriculum_epoch=2), dict(curriculum=True,
             curriculum_epoch=1, batch_size=4), dict(baseline=True), dict(guidance=2), dict(guidance=2, datalimit=5),
             dict(guidance=100, datalimit=50), dict(curriculum=True, cont_finetune=True), dict()]
    for case in cases:
        kw = dict(dict(ft_data=csv, batch_size=8), **case)
        classes = [1] if case.get("cont_finetune") else None
        got = curriculum.init_guidance_setting(ExperimentConfig(**kw), list_classes=classes)
        want = jax_curriculum.init_guidance_setting(JaxConfig(**kw), list_classes=classes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), case
    lg = [0, 2, 5, 100]
    for gid in range(4):
        assert curriculum.seq_curri_guid(lg, cur_guidance_id=gid, ctype="no_curri") == \
            jax_curriculum.seq_curri_guid(lg, cur_guidance_id=gid, ctype="no_curri")
        for times in (1, 2, 3):
            kw = dict(cur_guidance_id=gid, cur_str_times=times, ctype="in_curri", loop_times=2)
            assert curriculum.seq_curri_guid(lg, **kw) == jax_curriculum.seq_curri_guid(lg, **kw)
    assert curriculum.seq_curri_guid(lg) == jax_curriculum.seq_curri_guid(lg)
    with pytest.raises(ValueError, match="invalid ctype"):
        curriculum.seq_curri_guid(lg, ctype="other")
    progress = {0: 0.1, 2: 0.3, 5: -0.2, 100: 0.3}
    for explore in (False, True):
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        picks = [curriculum.choose_guidance_by_progress(progress, lg, explore, a) for _ in range(200)]
        assert picks == [jax_curriculum.choose_guidance_by_progress(progress, lg, explore, b) for _ in range(200)]
        assert len(set(picks)) == (4 if explore else 1)


def test_test_flag_skips_training(corpus, tmp_path):  # noqa: F811
    cfg = port_cfg(corpus, tmp_path, "test", test=True, epochs=1, save=None)
    assert flyp.flyp_train(cfg, model=port_model()) is None
    stats = pd.read_csv(os.path.join(cfg.log_dir, "stats.tsv"), sep="\t", index_col=0)
    assert list(stats.columns) == ["Epoch", "epoch", "PatchCamelyonVal Accuracy", "Avg OOD Acc", "Avg ID FLYP Loss"]
    assert stats["Avg ID FLYP Loss"].iloc[0] == 0.0
    assert not any("ID FLYP Loss" in m for m in _metrics(cfg.log_dir))


def test_non_finite_loss_raises(corpus, tmp_path):  # noqa: F811
    model = port_model()
    with torch.no_grad():
        model.logit_scale.fill_(float("nan"))
    cfg = port_cfg(corpus, tmp_path, "nan", epochs=1)
    with pytest.raises(FloatingPointError, match=r"non-finite loss nan at epoch 0 step 0; lr=5\.000e-04"):
        flyp.flyp_train(cfg, model=model)


def test_cont_finetune_filters_classes(corpus, tmp_path):  # noqa: F811
    doctored = tmp_path / "class_stats_doctored.tsv"
    pd.DataFrame(
        {"PatchCamelyonVal": [0.9, 0.9, 0.3], "PatchCamelyonVal Count": [100, 100, 100]},
        index=["Class 0", "Class 1", "Class 2"],
    ).to_csv(doctored, sep="\t")
    flags = dict(cont_finetune=True, class_stats_path=str(doctored), cont_filter_key="PatchCamelyonVal",
                 cont_acc_threshold=0.5, cont_count_threshold=50)
    cfg = port_cfg(corpus, tmp_path, "cont", epochs=1, save=None, **flags)
    log = type("Log", (), {"info": lambda self, m: None})()
    assert flyp._cont_finetune_classes(cfg, log) == jax_flyp._cont_finetune_classes(JaxConfig(**flags), log) == [2, 0]
    flyp.flyp_train(cfg, model=port_model(), print_every=2)
    with open(os.path.join(cfg.log_dir, "log.log")) as f:
        text = f.read()
    assert "based on 2 classes: [2, 0]" in text
    assert "Num batches is 2" in text  # 16 class-0 rows, batch 8 (4 batches unfiltered)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_matches_scikit_learn(seed):
    """The trainer's 1-D loss vectors; scikit-learn here holds the same
    partition, inertia to 1e-9 and, with its k-means++ draws reproduced,
    the same label ids."""
    from sklearn.cluster import KMeans

    rng = np.random.default_rng(seed)
    n = (64, 500, 2000)[seed]
    losses = np.concatenate([rng.gamma(2.0, 1.0, n), rng.normal(6.0, 0.5, n // 4)]).astype(np.float32).tolist()
    km = KMeans(n_clusters=7, random_state=0, n_init=10).fit(np.array(losses).reshape(-1, 1))
    labels, inertia, centers = kmeans(losses, n_clusters=7, seed=0, n_init=10)
    np.testing.assert_array_equal(labels, km.labels_)
    assert inertia == pytest.approx(km.inertia_, rel=1e-9)
    np.testing.assert_allclose(centers, km.cluster_centers_, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("impl", ["xla", "pallas_block"])
def test_remat_gradients_are_bit_equal(monkeypatch, impl):
    monkeypatch.setenv(port_attention._IMPL_ENV, impl)
    port_attention._default_impl.cache_clear()
    try:
        rng = np.random.default_rng(0)
        images = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
        tokens = torch.zeros((4, 16), dtype=torch.int32)
        tokens[:, 0], tokens[:, 6] = 49406, 49407
        tokens[:, 1:6] = torch.from_numpy(rng.integers(1, 49000, (4, 5)))
        grads = []
        for remat in (False, True):
            model = port_model()
            if remat:
                model = CLIPModel(model.config, remat=True)
                model.load_state_dict(port_model().state_dict())
            model.train()
            img_f, txt_f, scale = model(images, tokens)
            grads.append(torch.autograd.grad(clip_loss(img_f, txt_f, scale).mean(), list(model.parameters())))
        assert all(torch.equal(a, b) for a, b in zip(*grads))
        assert model.visual.transformer.block_0.remat and model.text.transformer.block_1.remat
    finally:
        port_attention._default_impl.cache_clear()


def test_trainer_runs_without_scikit_learn_or_orbax(corpus, tmp_path):  # noqa: F811
    """--cluster loss (the k-means) and --save in a process where importing
    scikit-learn or orbax fails."""
    fields = _fields(corpus, tmp_path, "isolated", epochs=1, progress_train=True, cluster="loss",
                     curriculum=True)
    code = f"""
import sys
sys.modules["sklearn"] = sys.modules["orbax"] = None
import dataclasses, os, pickle, torch
torch.set_num_threads(1)
from flyp_tpu_torch.config import ExperimentConfig
from flyp_tpu_torch.models import CLIPModel, MODEL_CONFIGS
from flyp_tpu_torch.training.flyp import flyp_train
c = MODEL_CONFIGS["ViT-B/16"]
tiny = dataclasses.replace(c, embed_dim=32, vision=dataclasses.replace(c.vision, image_size=32, width=64, layers=2,
    heads=1), text=dataclasses.replace(c.text, width=64, heads=1, layers=2))
cfg = ExperimentConfig(device="cpu", **{fields!r})
ret = flyp_train(cfg, model=CLIPModel(tiny).init_parameters(0))
pairs = pickle.load(open(os.path.join(cfg.log_dir, "group_guid0.pkl"), "rb"))
print("RESULT", os.path.basename(ret), len(pairs), sorted({{p[2] for p in pairs}}))
print("LOADED", sorted(n for n in sys.modules if n.split(".")[0] in ("sklearn", "orbax", "jax", "flax")
                       and sys.modules[n] is not None))
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.dirname(__file__)), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT checkpoint_0 32 [0, 1, 2, 3, 4, 5, 6]" in proc.stdout, proc.stdout[-2000:]
    assert "LOADED []" in proc.stdout


def test_cli_main_run_directories_and_refusals(corpus, tmp_path, monkeypatch):  # noqa: F811
    """``cli/main.py`` keys the run as the JAX CLI does (``<save>/<exp>/
    <run key>`` and ``expt_logs/<exp>/<run key>``), runs on ``--device
    cpu`` when asked, and dispatches ``--ce_ablation`` and
    ``--progress_validation`` to the research trainers, as the JAX CLI
    does."""
    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.models import factory
    from flyp_tpu_torch.training import ce_ablation, progress

    monkeypatch.chdir(tmp_path)
    argv = ["--train-dataset", "PatchCamelyonVal", "--template", "patchcamelyon_template", "--eval-datasets",
            "PatchCamelyonVal", "--data-location", corpus["root"], "--ft_data", corpus["train_csv"],
            "--batch-size", "8", "--epochs", "1", "--workers", "2", "--compute_dtype", "float32",
            "--model", "ViT-B/16", "--save", str(tmp_path / "ckpt"), "--exp_name", "cli"]
    reached = []
    monkeypatch.setattr(ce_ablation, "ce_ablation", lambda cfg, logger: reached.append(("ce", cfg)) or "ce")
    monkeypatch.setattr(progress, "flyp_progress_validation",
                        lambda cfg, logger: reached.append(("progress", cfg)) or "progress")
    for flag, name in (("--ce_ablation", "ce"), ("--progress_validation", "progress")):
        assert cli_main.main(cli_main.parse_main_arguments([*argv, flag, "--exp_name", name])) == name
        cfg = reached[-1][1]
        assert reached[-1][0] == name and cfg.device == "cuda" and getattr(cfg, flag[2:])
        assert cfg.save == os.path.join(str(tmp_path / "ckpt"), name, cfg.run_key())
        assert cfg.log_dir == os.path.join("expt_logs", name, cfg.run_key()) and os.path.isdir(cfg.log_dir)
    assert len(reached) == 2
    assert cli_main.parse_main_arguments(argv).device == "cuda"
    tiny = port_model().config
    real = factory.build_clip_model
    monkeypatch.setattr(factory, "build_clip_model", lambda cfg, device: real(cfg, config_override=tiny,
                                                                              device=device))
    ret = cli_main.main(cli_main.parse_main_arguments(["--device", "cpu", *argv]))
    key = JaxConfig(batch_size=8).run_key()
    assert key == "_BS8_WD0.1_LR0.001_run1"
    assert ret == os.path.join(str(tmp_path / "ckpt"), "cli", key, "checkpoint_0")
    assert checkpoint.read_meta(ret)["kind"] == "trainer"
    logs = tmp_path / "expt_logs" / "cli" / key
    assert sorted(os.listdir(logs)) == ["class_stats0.tsv", "log.log", "metrics.jsonl", "stats.tsv"]


FRAMES = {
    "stats": ([{"Epoch": 0, "a": 0.1 + 0.2, "b": 1e-05}, {"Epoch": 1, "a": 1.0, "b": 3, "c": 2}], None, None),
    "bools": ([{"Epoch": 0, "x": True}, {"Epoch": 1, "x": False}], None, None),
    "progress": ([{0: 0.5}, {0: 1}], ["Guidance 2", "Epoch"], [0]),
    "class_stats": ([{"A": 1.0, "A Count": 3, "B": 0, "B Count": 0}, {"A": 0.25, "A Count": 4, "B": 0.5,
                                                                      "B Count": 2}], ["Class 0", "Class 1"], None),
    "extremes": ([{"a": 12345678.123456789, "b": 1e16, "c": -0.0, "d": float("nan")}], None, None),
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_tsv_writer_matches_pandas(tmp_path, frame):
    """The trainer's TSVs as ``DataFrame.to_csv(sep="\\t")`` writes them,
    read back as ``read_csv(index_col=0)`` types them (with its correctly
    rounded float parser: pandas' default one reads 0.30000000000000004
    as 0.3, where the port reads every written value back exactly)."""
    rows, index, columns = FRAMES[frame]
    index = list(range(len(rows))) if index is None else index
    path = str(tmp_path / "t.tsv")
    flyp._write_tsv(path, index, rows, columns)
    with open(path) as f:
        assert f.read() == pd.DataFrame(rows, index=index, columns=columns).to_csv(sep="\t")
    got_index, got_rows = flyp._read_tsv(path)
    want = pd.read_csv(path, sep="\t", index_col=0, float_precision="round_trip")
    assert got_index == list(want.index)
    for got, (_, row) in zip(got_rows, want.iterrows()):
        assert list(got) == list(row.index)
        for k, v in got.items():
            assert (pd.isna(v) and pd.isna(row[k])) or v == row[k], (k, v, row[k])


@pytest.mark.parametrize("option", ["progress_eval", "log_grad_norm", "freeze_encoder", "crestart"])
def test_trainer_options(corpus, tmp_path, option):  # noqa: F811
    """Options the JAX comparison does not run: their artifacts and records."""
    flags = {"progress_eval": dict(curriculum=True, progress_eval=True), "log_grad_norm": dict(log_grad_norm=True),
             "freeze_encoder": dict(freeze_encoder=True), "crestart": dict(scheduler="crestart", epochs=2)}[option]
    model = port_model()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = port_cfg(corpus, tmp_path, option, **{"baseline": "curriculum" not in flags, "epochs": 1, **flags})
    flyp.flyp_train(cfg, model=model, print_every=2)
    steps = [m for m in _metrics(cfg.log_dir) if "ID FLYP Loss" in m]
    if option == "progress_eval":
        progress = pd.read_csv(os.path.join(cfg.log_dir, "progress0.tsv"), sep="\t", index_col=0)
        assert list(progress.index) == ["Guidance 2", "Guidance 100", "Epoch"] and list(progress.columns) == ["0"]
        with open(os.path.join(cfg.log_dir, "progress0.pkl"), "rb") as f:
            last_perform, moving = __import__("pickle").load(f)
        assert set(last_perform) >= {"Guidance 2 Accuracy", "Guidance 100 Accuracy"} and moving == {}
    elif option == "log_grad_norm":
        assert all(list(m)[-1] == "Gradient Norm" and m["Gradient Norm"] > 0 for m in steps)
    elif option == "freeze_encoder":
        after = model.state_dict()
        assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("visual."))
        assert not torch.equal(after["text.text_projection"], before["text.text_projection"])
    else:  # crestart: the rate is constant within an epoch
        rates = [(m["Epoch"], m["Learning Rate"]) for m in steps]
        assert len(rates) == 4 and rates[0][1] == rates[1][1] and rates[2][1] == rates[3][1] != rates[0][1]
