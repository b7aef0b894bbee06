"""The port's diagonal Fisher (``flyp_tpu_torch/training/fisher.py``) against
the JAX package's ``make_fisher_step``, and its pickle against JAX's.

The step: JAX's labels come from ``jax.random.categorical`` on its own
sampling logits (as ``tests/test_research_trainers.py`` draws them: the
ViT's from one eval-mode batch forward, the tiny RN's from per-example
training-mode forwards), and the port's step is given those labels; every
parameter's sum of squared per-example gradients within rtol 1e-4, atol 1e-6
(that test's own tolerance).  The tiny RN reaches a 1x1 map at layer4, so
each single-example pass runs the one-value BatchNorm (fault C4).  Without
labels the port draws its own from a seeded generator: the same seed gives
the same labels.  The pickle: nested float32 numpy dicts shaped as JAX's
parameter tree, read by either package's WiSE-FT merge.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.training import fisher as jax_fisher
from flyp_tpu.training.wise import fisher_interpolate as jax_fisher_interpolate
from flyp_tpu.utils.logging import get_logger
from flyp_tpu_torch.models import convert
from flyp_tpu_torch.training import fisher, wise
from tests.test_flyp_trainer import tiny_resnet
from tests.test_research_trainers import corpus, make_cfg, tiny_model  # noqa: F401
from tests.torch_research_helpers import host, port_cfg, port_model

torch.set_num_threads(1)
N, CLASSES = 4, 5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(32, CLASSES)).astype(np.float32)
    images = rng.normal(size=(N, 32, 32, 3)).astype(np.float32)
    return W, images


def _jax_labels(jmodel, variables, head, images, rng):
    """The labels JAX's step draws inside: categorical on its sampling
    logits."""
    params, stats = variables["params"], variables.get("batch_stats")
    if stats is None:
        feats = jmodel.apply({"params": params}, images, method="encode_image")
    else:
        def enc1(im):
            f, _ = jmodel.apply({"params": params, "batch_stats": stats}, im[None], method="encode_image",
                                train=True, mutable=["batch_stats"])
            return f[0]
        feats = jnp.stack([enc1(im) for im in images])
    return jax.random.categorical(rng, head(feats).astype(jnp.float32), axis=-1)


@pytest.mark.parametrize("tower", ["vit", "rn"])
def test_fisher_step_matches_jax(tower):
    jmodel, variables = (tiny_model if tower == "vit" else tiny_resnet)()
    variables = host(variables)
    W, images = _inputs()
    jhead = lambda f: f.astype(jnp.float32) @ jnp.asarray(W)  # noqa: E731
    rng = jax.random.key(7)
    sq_sum, n = jax_fisher.make_fisher_step(jmodel, jhead)(variables["params"], variables.get("batch_stats"),
                                                           jnp.asarray(images), rng)
    labels = _jax_labels(jmodel, variables, jhead, jnp.asarray(images), rng)
    want = convert.from_jax_params(host(sq_sum))

    model = port_model(jmodel, variables)
    stats_before = {k: v.clone() for k, v in model.named_buffers()}
    flags = [p.requires_grad for p in model.parameters()]
    step = fisher.make_fisher_step(model, lambda f: f.float() @ torch.from_numpy(W))
    got, m = step(torch.from_numpy(images), torch.from_numpy(np.array(labels)))
    assert int(n) == m == N
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    assert any(float(got[k].abs().max()) > 0 for k in got if k.startswith("visual."))
    assert all(not got[k].any() for k in got if k.startswith("text.") or k == "logit_scale")
    # The running statistics are read, never written; the model's flags are given back.
    for k, v in model.named_buffers():
        assert torch.equal(v, stats_before[k]), k
    assert [p.requires_grad for p in model.parameters()] == flags


def test_fisher_step_draws_seeded_labels(monkeypatch):
    """Without labels the step samples from the softmax of the head's
    logits with its own generator: one seed, one sequence of draws."""
    jmodel, variables = tiny_model()
    W, images = _inputs(1)
    model = port_model(jmodel, variables)
    drawn = []
    real = torch.multinomial
    monkeypatch.setattr(torch, "multinomial", lambda *a, **k: drawn.append(real(*a, **k)) or drawn[-1])

    def run(seed):
        step = fisher.make_fisher_step(model, lambda f: f.float() @ torch.from_numpy(W) * 10, seed=seed)
        return [step(torch.from_numpy(images))[0] for _ in range(2)]

    a, b = run(3), run(3)
    assert len(drawn) == 4 and torch.equal(drawn[0], drawn[2]) and torch.equal(drawn[1], drawn[3])
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_fisher_pickles_read_by_either_package(corpus, tmp_path):  # noqa: F811
    """``compute_fisher`` of each package: the same nested layout (JAX's
    parameter tree, float32 numpy leaves, non-negative), each file merged by
    the other package's ``fisher_interpolate``."""
    jmodel, variables = tiny_model()
    variables = host(variables)
    paths = {pkg: str(tmp_path / f"{pkg}.pkl") for pkg in ("jax", "port")}
    fields = dict(train_dataset="PatchCamelyonTrain", epochs=1)
    jax_fisher.compute_fisher(make_cfg(corpus, tmp_path, fisher=[paths["jax"]], **fields), get_logger(None),
                              model=jmodel, variables=variables, max_batches=1)
    ret = fisher.compute_fisher(port_cfg(corpus, tmp_path, fisher=[paths["port"]], **fields), get_logger(None),
                                model=port_model(jmodel, variables), max_batches=1)
    with open(paths["jax"], "rb") as f:
        jtree = pickle.load(f)
    with open(paths["port"], "rb") as f:
        ptree = pickle.load(f)
    assert jax.tree_util.tree_structure(ptree) == jax.tree_util.tree_structure(jtree) \
        == jax.tree_util.tree_structure(variables["params"])
    for a, b in zip(jax.tree_util.tree_leaves(ptree), jax.tree_util.tree_leaves(jtree)):
        assert type(a) is np.ndarray and a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert (a >= 0).all()
    assert jax.tree_util.tree_structure(ret) == jax.tree_util.tree_structure(ptree)

    zs, ft = variables["params"], jax.tree_util.tree_map(lambda x: x * 0.5, variables["params"])
    merged_jax = jax_fisher_interpolate(zs, ft, ptree, ptree, alpha=0.5)
    flat = convert.from_jax_params
    merged_port = wise.fisher_interpolate(flat(zs), flat(ft), flat(jtree), flat(jtree), alpha=0.5)
    want = flat(host(jax_fisher_interpolate(zs, ft, jtree, jtree, alpha=0.5)))
    for k in want:
        np.testing.assert_array_max_ulp(merged_port[k].numpy(), want[k].numpy(), maxulp=1)
    assert os.path.getsize(paths["port"]) > 0 and jax.tree_util.tree_leaves(merged_jax)
