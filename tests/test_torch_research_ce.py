"""The port's cross-entropy ablation (``flyp_tpu_torch/training/
ce_ablation.py``) against the JAX package's, and across ranks.

* The step: JAX's ``make_ce_train_step`` under
  ``optax.inject_hyperparams(optax.sgd)(learning_rate=1.0)`` moves each
  parameter by minus its gradient, and so does the port's step under the
  same SGD, so old minus new parameters is each side's gradient.  The
  loss within 1e-6 and each parameter's gradient within 1e-5 of its norm
  (measured: 1.8e-6 at most).  The ViT leg runs the towers in eval mode (B3
  forward, B1 + B2 backward on the card; their plain versions here), with
  label smoothing.  On the RN the loss within 5e-6 and the running
  statistics within rtol 1e-5 (``tests/test_torch_resnet.py``'s bounds), the
  text tower's and the scale's gradients within 1e-5; the image tower's
  training-mode BatchNorm amplifies fp32 rounding into gradients "by up to
  percents" (ROADMAP, "What the parity tests showed"; measured here up to
  1.9e-2), so each of its gradients is held within 0.1 of its norm, and
  ``attnpool.k_proj.bias``, whose gradient is zero in exact arithmetic
  (softmax ignores a constant added to every key), to rounding size on both
  sides.
* The trainer: ``ce_ablation`` end to end against JAX's: the per-step
  losses (the template picks of ``default_rng(seed)`` equal) within 1e-5,
  the learning rates within one fp32 ulp, and ``stats.tsv``'s columns.
* Across ranks: 2 gloo processes (each its rows of the global batch, the
  gradients summed) against one process, 5 AdamW steps at lr 1e-4: the
  ranks' parameters and statistics bit-equal; each parameter within twice
  the summed rates of the one-process run's (Adam's first steps are
  sign-like) and all of them within 5e-2 of its movement from the start
  (measured: ViT 6.9e-3, RN 3.2e-2), the RN's running statistics within
  0.3 of theirs (phase 12's bound; measured 4.2e-4); the first logged loss
  within 1e-5 relative (the same weights), later ones within 1e-5 (ViT) and
  1e-2 (RN, phase 12's bound for a BatchNorm tower) relative.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from flyp_tpu.training import ce_ablation as jax_ce
from flyp_tpu.training.train_state import create_train_state as jax_create_train_state
from flyp_tpu.utils.logging import get_logger
from flyp_tpu_torch.models import convert
from flyp_tpu_torch.tokenizer import shrink_context
from flyp_tpu_torch.training import ce_ablation
from flyp_tpu_torch.training.train_state import AdamWState, create_train_state
from tests.test_flyp_trainer import tiny_resnet
from tests.test_research_trainers import corpus, make_cfg, tiny_model  # noqa: F401
from tests.torch_parallel_workers import ce_ablation_runs, run_ranks
from tests.torch_research_helpers import host, port_cfg, port_model

torch.set_num_threads(1)


class SGD:
    """Plain SGD with the port optimizer's interface (``p - lr g``)."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return AdamWState(count=torch.zeros((), dtype=torch.int32), mu=[], nu=[])

    @torch.no_grad()
    def update(self, params, grads, state, frozen=None):
        for p, g in zip(params, grads):
            p.copy_(p - self.lr * g)
        state.count.add_(1)
        return torch.tensor(self.lr)


def _batch(B=6, C=3, seed=0):
    """Images, labels and C prompts (BOS, ids, EOT; shrunk)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    texts = np.zeros((C, 77), np.int32)
    texts[:, 0] = 49406
    for i, n in enumerate(rng.integers(4, 12, C)):
        texts[i, 1:n] = rng.integers(1, 49000, n - 1)
        texts[i, n] = 49407
    return images, labels, shrink_context(texts)


STEP_CASES = {"vit": (tiny_model, 0.1, dict(loss=1e-6, rel=1e-5, amplified=None, zero=())),
              "rn": (tiny_resnet, 0.0, dict(loss=5e-6, rel=1e-5, amplified=0.1,
                                            zero=("visual.attnpool.k_proj.bias",)))}


@pytest.mark.parametrize("tower", list(STEP_CASES))
def test_ce_step_loss_and_gradients_match_jax(tower):
    make, ls, tol = STEP_CASES[tower]
    jmodel, variables = make()
    variables = host(variables)  # the jitted step donates its state
    images, labels, texts = _batch()
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=1.0)
    jstate = jax_create_train_state(variables["params"], opt, variables.get("batch_stats"))
    jstep = jax_ce.make_ce_train_step(jmodel, opt, label_smoothing=ls)
    jnew, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(texts))
    want = convert.from_jax_params(host(jnew.params), host(jnew.batch_stats or {}))

    model = port_model(jmodel, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, SGD(1.0))
    step = ce_ablation.make_ce_train_step(model, SGD(1.0), label_smoothing=ls)
    state, metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(texts))
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), abs=tol["loss"])
    assert float(metrics["learning_rate"]) == float(jmetrics["learning_rate"]) == 1.0
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    buffers = dict(model.named_buffers())
    for k in buffers:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
        assert not torch.equal(got[k], before[k])  # training-mode BatchNorm moved them
    grads = {k: ((before[k] - got[k]).double(), (before[k] - want[k]).double()) for k in want if k not in buffers}
    assert all(gp.norm() > 0 for k, (gp, _) in grads.items() if k not in tol["zero"])
    largest = max(float(gj.norm()) for _, gj in grads.values())
    for k, (gp, gj) in grads.items():
        if k in tol["zero"]:  # zero in exact arithmetic: both rounding-sized
            assert float(gp.norm()) < 1e-4 * largest and float(gj.norm()) < 1e-4 * largest, k
            continue
        rel = tol["amplified"] if tol["amplified"] and k.startswith("visual.") else tol["rel"]
        assert float((gp - gj).norm()) <= rel * float(gj.norm()), (k, float((gp - gj).norm() / gj.norm()))
    assert model.training  # create_train_state's mode, given back


def _ce_fields(corpus, root, name, **overrides):  # noqa: F811
    return dict(train_dataset="PatchCamelyonTrain", epochs=1, batch_size=4, debug=False, seed=0,
                log_dir=str(root / name), **overrides)


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "ID CE Loss" in r]


def test_ce_ablation_matches_jax(corpus, tmp_path):  # noqa: F811
    """One epoch of the trainer: the template picks, the per-step losses
    and rates, the evaluation and ``stats.tsv``."""
    jmodel, variables = tiny_model()
    variables = host(variables)
    jcfg = make_cfg(corpus, tmp_path, **_ce_fields(corpus, tmp_path, "jax"))
    jax_ce.ce_ablation(jcfg, get_logger(None), model=jmodel, variables=variables, print_every=2)
    cfg = port_cfg(corpus, tmp_path, **_ce_fields(corpus, tmp_path, "port"))
    ret = ce_ablation.ce_ablation(cfg, get_logger(None), model=port_model(jmodel, variables), print_every=2)
    assert ret is None  # no --save
    want, got = _metrics(jcfg.log_dir), _metrics(cfg.log_dir)
    assert len(got) == len(want) == 5  # 20 train images, batch 4
    for g, w in zip(got, want):
        assert g["Epoch"] == w["Epoch"] == 0
        assert g["ID CE Loss"] == pytest.approx(w["ID CE Loss"], abs=1e-5)
        np.testing.assert_array_max_ulp(np.float32(g["Learning Rate"]), np.float32(w["Learning Rate"]), maxulp=1)
    jstats = pd.read_csv(os.path.join(jcfg.log_dir, "stats.tsv"), sep="\t", index_col=0)
    stats = pd.read_csv(os.path.join(cfg.log_dir, "stats.tsv"), sep="\t", index_col=0)
    assert list(stats.columns) == list(jstats.columns)
    for col in ("PatchCamelyonVal Accuracy", "PatchCamelyonTest Accuracy", "Avg OOD Acc"):
        assert stats[col].tolist() == jstats[col].tolist()
    np.testing.assert_allclose(stats["Avg ID FLYP Loss"], jstats["Avg ID FLYP Loss"], atol=1e-4 + 1e-9)


STEPS, LR, PARAM_TOL, STATS_TOL = 5, 1e-4, 5e-2, 0.3
LOSS_RTOL = {"vit": 1e-5, "rn": 1e-2}


def test_ce_ablation_on_two_ranks_matches_one_process(corpus, tmp_path):  # noqa: F811
    runs, ones = [], {}
    for tower, make in (("vit", tiny_model), ("rn", tiny_resnet)):
        jmodel, variables = make()
        fields = dataclasses.asdict(port_cfg(corpus, tmp_path, **_ce_fields(corpus, tmp_path, f"{tower}_2")))
        fields["lr"] = LR
        runs.append((tower, fields, port_model(jmodel, variables).config,
                     port_model(jmodel, variables).state_dict()))
        one = port_model(jmodel, variables)
        cfg = port_cfg(corpus, tmp_path, **_ce_fields(corpus, tmp_path, f"{tower}_1"))
        cfg.lr = LR
        ce_ablation.ce_ablation(cfg, get_logger(None), model=one, print_every=1)
        ones[tower] = one.state_dict()
    ranks = run_ranks(ce_ablation_runs, 2, runs)
    for tower, fields, _, init in runs:
        got, want = ranks[0][tower], ones[tower]
        stats = {k for k in want if k.endswith((".mean", ".var")) and "bn" in k}
        for k in want:
            assert torch.equal(ranks[1][tower][k], got[k]), k  # the replicas stay equal
            if k not in stats:
                # Adam's first steps are sign-like: twice the summed rates.
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=2 * STEPS * LR,
                                           err_msg=f"{tower} {k}")
        for keys, bound in ((set(want) - stats, PARAM_TOL), (stats, STATS_TOL)):
            if keys:
                off = sum(float((got[k].double() - want[k].double()).pow(2).sum()) for k in keys)
                moved = sum(float((want[k].double() - init[k].double()).pow(2).sum()) for k in keys)
                assert (off / moved) ** 0.5 <= bound, tower
        losses = [r["ID CE Loss"] for r in _metrics(fields["log_dir"])]
        one_losses = [r["ID CE Loss"] for r in _metrics(str(tmp_path / f"{tower}_1"))]
        assert len(losses) == len(one_losses) == STEPS
        # The same weights at step 0: only sums reorder (the RN's BatchNorm statistics over two ranks).
        assert abs(losses[0] - one_losses[0]) <= 1e-5 * abs(one_losses[0]), tower
        np.testing.assert_allclose(losses, one_losses, rtol=LOSS_RTOL[tower], atol=0, err_msg=tower)
