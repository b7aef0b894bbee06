"""The research trainers' small parts (``flyp_tpu_torch/training/{wise,
few_shot,linear_probe}.py``, ``models/resnet.py``'s one-value BatchNorm)
against the JAX package's on the same numpy inputs.

Tolerances: WiSE-FT within 1 fp32 ulp of JAX's (one multiply-add per
element, rounded in either order); the few-shot scans bit-equal (the loaders
are); the one-value-per-channel BatchNorm's output, gradients and running
statistics within 1e-6 (the output is ``bias`` and ``dx`` zero in both);
the probe's best index, C and accuracy equal to scikit-learn's, its
coefficients within 2e-3 of their norm (both stop L-BFGS at ``gtol`` 1e-4
on float32 losses summed in another order).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.data.csv_data import get_csv_loader as jax_get_csv_loader
from flyp_tpu.data.registry import get_dataset_class as jax_get_dataset_class
from flyp_tpu.data.transforms import eval_transform as jax_eval_transform
from flyp_tpu.models.resnet import TorchBatchNorm as JaxTorchBatchNorm
from flyp_tpu.training import few_shot as jax_few_shot
from flyp_tpu.training import wise as jax_wise
from flyp_tpu.training.linear_probe import log_reg_warm_start_sweep as jax_sweep
from flyp_tpu_torch.data.csv_data import get_csv_loader
from flyp_tpu_torch.data.registry import get_dataset_class
from flyp_tpu_torch.data.transforms import eval_transform
from flyp_tpu_torch.models import convert, resnet
from flyp_tpu_torch.models.head import ClassificationHead
from flyp_tpu_torch.training import few_shot, linear_probe, progress, wise
from tests.test_research_trainers import corpus, make_cfg  # noqa: F401
from tests.torch_research_helpers import port_cfg

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
RESEARCH_MODULES = ["training/wise.py", "training/few_shot.py", "training/ce_ablation.py", "training/fisher.py",
                    "training/linear_probe.py", "training/progress.py", "cli/few_shot.py"]


@pytest.mark.parametrize("module", RESEARCH_MODULES)
def test_research_module_stands_alone(module):
    """Each research module exists and imports nothing of JAX or the JAX
    package (``test_torch_imports.py`` walks them at run time too)."""
    tree = ast.parse((REPO / "flyp_tpu_torch" / module).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"jax", "jaxlib", "flax", "optax", "orbax", "flyp_tpu", "sklearn"}, roots


# -- C4: train-mode BatchNorm on one value a channel --------------------------


def test_batchnorm_one_value_per_channel_matches_jax():
    """A ``[1, C, 1, 1]`` train-mode input (a per-example pass at a 1x1 map)
    gives JAX's output (``bias``), gradients (``dx`` 0, ``dscale`` 0,
    ``dbias`` = g) and running statistics (``var`` moved with n/max(n-1, 1)
    = 1), where ``F.batch_norm`` raises."""
    rng = np.random.default_rng(0)
    C = 16
    x = rng.standard_normal((1, 1, 1, C)).astype(np.float32)
    g = rng.standard_normal((1, 1, 1, C)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32), "bias": rng.standard_normal(C).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        torch.nn.functional.batch_norm(torch.zeros(1, C, 1, 1), None, None, training=True)

    jbn = JaxTorchBatchNorm(momentum=0.9, epsilon=1e-5)

    def fwd(p, xx):
        return jbn.apply({"params": p, "batch_stats": stats}, xx, use_running_average=False, mutable=["batch_stats"])

    y, upd = fwd(params, jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, xx: fwd(p, xx)[0], params, jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))

    bn = resnet.TorchBatchNorm(C).train()
    bn.load_state_dict(convert.from_jax_params(params, stats), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = bn(xt)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), **tol)
    np.testing.assert_allclose(out.detach().reshape(-1).numpy(), params["bias"], **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dx), **tol)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(dparams["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(dparams["bias"]), **tol)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]), **tol)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 * stats["var"], rtol=1e-6)


@pytest.mark.parametrize("shape,via_library", [((1, 4, 1, 1), False), ((2, 4, 1, 1), True), ((1, 4, 2, 1), True)])
def test_batchnorm_takes_f_batch_norm_beyond_one_value(monkeypatch, shape, via_library):
    """Only a train-mode input of one value a channel leaves ``F.batch_norm``:
    every other shape's numbers are unchanged."""
    calls = []
    real = resnet.F.batch_norm
    monkeypatch.setattr(resnet.F, "batch_norm", lambda *a, **k: calls.append(1) or real(*a, **k))
    bn = resnet.TorchBatchNorm(4).train()
    torch.manual_seed(0)
    bn(torch.randn(shape))
    assert bool(calls) == via_library
    with resnet.running_stats_frozen(bn):
        before = bn.var.clone()
        bn(torch.randn(shape))
        assert torch.equal(bn.var, before)


# -- WiSE-FT -------------------------------------------------------------------


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"visual": {"proj": (8, 4), "ln_post": {"scale": (8,)}}, "logit_scale": ()}

    def draw(scale=1.0, positive=False):
        out = jax.tree_util.tree_map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
                                     is_leaf=lambda s: isinstance(s, tuple))
        return jax.tree_util.tree_map(np.abs, out) if positive else out

    z, f = draw(), draw()
    fz, ff = draw(1e-3, True), draw(1e-3, True)
    fz["visual"]["proj"][0, :2] = 0.0  # below the floor
    return z, f, fz, ff


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_wise_matches_jax(alpha):
    z, f, fz, ff = _trees()
    flat = convert.from_jax_params
    want = flat(jax.tree_util.tree_map(np.asarray, jax_wise.interpolate(z, f, alpha)))
    got = wise.interpolate(flat(z), flat(f), alpha)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_max_ulp(got[k].numpy(), want[k].numpy(), maxulp=1)
    want = flat(jax.tree_util.tree_map(np.asarray, jax_wise.fisher_interpolate(z, f, fz, ff, alpha=alpha,
                                                                               fisher_floor=1e-8)))
    got = wise.fisher_interpolate(flat(z), flat(f), flat(fz), flat(ff), alpha=alpha, fisher_floor=1e-8)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_max_ulp(got[k].numpy(), want[k].numpy(), maxulp=1)


# -- few-shot scans --------------------------------------------------------------


def test_few_shot_scans_match_jax(corpus, tmp_path):  # noqa: F811
    """The balanced train batch (from the contrastive CSV at batch k) and
    the balanced validation batch (from PatchCamelyonVal) equal JAX's."""
    k = 4
    jcfg = make_cfg(corpus, tmp_path, k=k, batch_size=k)
    cfg = port_cfg(corpus, tmp_path, k=k, batch_size=k)
    want = jax_few_shot._collect_balanced_contrastive_batch(
        jax_get_csv_loader(jcfg, is_train=True, image_size=32, shard_by_process=False), k)
    got = few_shot._collect_balanced_contrastive_batch(
        get_csv_loader(cfg, is_train=True, image_size=32, shard_by_process=False), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (2 * k, 32, 32, 3) and len({t.tobytes() for t in got[1]}) == 2

    def val(pkg_cls, transform):
        return pkg_cls("PatchCamelyonVal")(preprocess=transform(32), location=corpus["root"], batch_size=k,
                                          num_workers=2, k=k).test_loader

    want = jax_few_shot._collect_balanced_label_batch(val(jax_get_dataset_class, jax_eval_transform), k)
    got = few_shot._collect_balanced_label_batch(val(get_dataset_class, eval_transform), k)
    for key in ("image", "label"):
        np.testing.assert_array_equal(got[key], want[key])
    assert list(got["label"]) == [0] * k + [1] * k


def test_few_shot_scan_bounded_on_single_class(corpus, tmp_path):  # noqa: F811
    import pandas as pd

    df = pd.read_csv(corpus["train_csv"], sep="\t")
    csv = tmp_path / "one_class.tsv"
    df[df["label"] == 0].to_csv(csv, sep="\t", index=False)
    cfg = port_cfg(corpus, tmp_path, k=4, ft_data=str(csv))
    with pytest.raises(RuntimeError, match="balanced few-shot batch"):
        few_shot._collect_balanced_contrastive_batch(get_csv_loader(cfg, is_train=True, image_size=32), k=4)


@pytest.mark.parametrize("trainer", ["few_shot", "progress"])
def test_single_process_protocols_refuse_several(monkeypatch, corpus, tmp_path, trainer):  # noqa: F811
    """Few-shot and the beam search are one process's protocols, as in JAX:
    under more than one they raise before any work."""
    cfg = port_cfg(corpus, tmp_path, k=4, save=str(tmp_path / "snaps"))
    module = {"few_shot": few_shot, "progress": progress}[trainer]
    monkeypatch.setattr(module, "process_count", lambda: 2)
    run = {"few_shot": lambda: few_shot.flyp_few_shot(cfg, None),
           "progress": lambda: progress.flyp_progress_validation(cfg, _Quiet())}[trainer]
    with pytest.raises(NotImplementedError, match="single-process"):
        run()
    assert not (tmp_path / "snaps").exists()


class _Quiet:
    def info(self, *_):
        pass


# -- linear probe ----------------------------------------------------------------


def _probe_data(classes: int, seed: int = 0):
    """Overlapping Gaussian blobs in 32 dimensions, float32, as features
    come from the image tower: separable enough that accuracy changes along
    the C grid."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((classes, 32)) * 0.6
    labels = {s: rng.integers(0, classes, n) for s, n in (("train", 120), ("test", 80))}
    feats = {s: (centres[labels[s]] + rng.standard_normal((len(labels[s]), 32))).astype(np.float32) for s in labels}
    if classes == 2:
        labels = {s: np.where(v == 1, 7, 3) for s, v in labels.items()}  # predict maps back to the labels
    return feats["train"], labels["train"], feats["test"], labels["test"]


@pytest.mark.parametrize("classes", [2, 3])
def test_probe_sweep_matches_scikit_learn(classes):
    data = _probe_data(classes)
    want = jax_sweep(*data, num_cs=12, start_c=-3, end_c=1)
    got = linear_probe.log_reg_warm_start_sweep(*data, num_cs=12, start_c=-3, end_c=1, device="cpu")
    assert (got["i"], got["c"], got["acc"]) == (want["i"], want["c"], want["acc"])
    assert got["coef"].shape == want["coef"].shape == ((1, 32) if classes == 2 else (classes, 32))
    assert got["coef"].dtype == want["coef"].dtype == np.float32
    w_got = np.concatenate([got["coef"], got["intercept"][:, None]], 1)
    w_want = np.concatenate([want["coef"], want["intercept"][:, None]], 1)
    assert np.linalg.norm(w_got - w_want) <= 2e-3 * np.linalg.norm(w_want)


@pytest.mark.parametrize("classes", [2, 3])
def test_probe_fit_path_matches_scikit_learn(classes):
    """Each fit of the warm-started path, and its predictions."""
    from sklearn.linear_model import LogisticRegression as SkLogisticRegression

    X, y, X_test, _ = _probe_data(classes, seed=1)
    sk = SkLogisticRegression(random_state=0, warm_start=True, max_iter=200)
    ours = linear_probe.LogisticRegression(max_iter=200)
    for c in (0.01, 0.3, 10.0):
        sk.C = ours.C = c
        sk.fit(X, y)
        ours.fit(torch.from_numpy(X), y)
        np.testing.assert_array_equal(ours.classes_, sk.classes_)
        w_got = np.concatenate([ours.coef_, ours.intercept_[:, None]], 1)
        w_want = np.concatenate([sk.coef_, sk.intercept_[:, None]], 1)
        assert np.linalg.norm(w_got - w_want) <= 2e-3 * np.linalg.norm(w_want), c
        np.testing.assert_array_equal(ours.predict(torch.from_numpy(X_test)), sk.predict(X_test))


def test_classification_head_zeros():
    head = ClassificationHead.zeros(3, 8)
    assert head.weight.shape == (3, 8) and not head.weight.any() and head.normalize
    assert torch.equal(head(torch.ones(2, 8)), torch.zeros(2, 3))
