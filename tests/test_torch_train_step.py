"""The port's train step and classifier against the JAX package's.

A tiny CLIP (``__graft_entry__._tiny_config()``: 2-layer 128-wide towers,
head_dim 64, 32-token context) initialised by the JAX package; its params
cross to the port through ``from_jax_params``.  A 3-step trajectory of the
port's ``make_train_step`` (CPU route: the plain versions of the
attention-block kernels) is held to JAX's ``make_train_step(model,
optimizer, mesh=None, donate=False)`` in fp32 under ``FLYP_ATTENTION_IMPL``
values ``xla``, ``pallas``, ``pallas_qkv``, ``pallas_block`` and
``pallas_block_mlp``, the port and JAX under the same one (JAX's kernels in
interpret mode).
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flyp_tpu.evaluation.classifier import Classifier as JaxClassifier
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.models.head import ClassificationHead as JaxHead
import flyp_tpu.ops.flash_attention as jax_flash_attention_mod
from flyp_tpu.ops.attention import _IMPL_ENV, _default_impl
from flyp_tpu.tokenizer import shrink_context
from flyp_tpu.training.schedules import warmup_cosine_lr as jax_warmup_cosine_lr
from flyp_tpu.training.train_state import create_train_state as jax_create_train_state
from flyp_tpu.training.train_state import make_optimizer as jax_make_optimizer
from flyp_tpu.training.train_step import make_train_step as jax_make_train_step
from flyp_tpu_torch.evaluation import Classifier
from flyp_tpu_torch.models import CLIPModel, ClassificationHead, build_clip_model, convert
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.ops import attention_block as tab
from flyp_tpu_torch.ops import flash_attention as tfa
from flyp_tpu_torch.ops import fused_qkv_attention as tfq
from flyp_tpu_torch.ops import mlp_block as tmb
from flyp_tpu_torch.ops.attention import _default_impl as port_default_impl
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr

torch.set_num_threads(1)

SCHEDULE = (1e-3, 2, 10)  # warmup_cosine_lr: rates 5e-4, 1e-3, 9.6e-4 over the 3 steps
STEPS = 3


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


def _batch(B=4, seed=0, vocab=1024, ctx=32):
    """Images and captions as the JAX bench makes them: BOS, random ids for
    a length drawn in 6-20, EOT (the highest id, where the tower pools),
    cut by shrink_context."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    tokens = np.zeros((B, ctx), np.int32)
    tokens[:, 0] = vocab - 2
    for i, n in enumerate(rng.integers(6, 20, B)):
        tokens[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        tokens[i, n] = vocab - 1
    return images, shrink_context(tokens)


@pytest.fixture(scope="module")
def tiny():
    jcfg = _tiny_config()
    jmodel = JaxCLIPModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jmodel, 0))
    return SimpleNamespace(jcfg=jcfg, jmodel=jmodel, params=params)


def _port_model(tiny):
    model = CLIPModel(port_config(tiny.jcfg))
    model.load_state_dict(convert.from_jax_params(tiny.params), strict=True)
    return model


def _jax_run(tiny, impl, batch, steps=STEPS, labels=None, **step_kwargs):
    """Per-step metrics and the final params of JAX's step under ``impl``."""
    saved = os.environ.get(_IMPL_ENV)
    os.environ[_IMPL_ENV] = impl
    _default_impl.cache_clear()
    port_default_impl.cache_clear()
    try:
        opt = jax_make_optimizer(jax_warmup_cosine_lr(*SCHEDULE), weight_decay=0.1)
        state = jax_create_train_state(jax.tree_util.tree_map(jnp.asarray, tiny.params), opt)
        step = jax_make_train_step(tiny.jmodel, opt, mesh=None, donate=False, **step_kwargs)
        args = [jnp.asarray(a) for a in batch] + ([] if labels is None else [jnp.asarray(labels)])
        metrics = []
        for _ in range(steps):
            state, m = step(state, *args)
            metrics.append(jax.tree_util.tree_map(np.asarray, m))
        return metrics, jax.tree_util.tree_map(np.asarray, state.params)
    finally:
        if saved is None:
            os.environ.pop(_IMPL_ENV, None)
        else:
            os.environ[_IMPL_ENV] = saved
        _default_impl.cache_clear()
        port_default_impl.cache_clear()


def _port_run(tiny, batch, steps=STEPS, labels=None, **step_kwargs):
    model = _port_model(tiny)
    opt = make_optimizer(warmup_cosine_lr(*SCHEDULE), weight_decay=0.1)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, **step_kwargs)
    args = [torch.from_numpy(a) for a in batch] + ([] if labels is None else [torch.from_numpy(labels).long()])
    metrics = []
    for _ in range(steps):
        state, m = step(state, *args)
        metrics.append({k: v.numpy() for k, v in m.items()})
    assert state.step == steps and int(state.opt_state.count) == steps
    return metrics, {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _compare(port, ref, param_atol):
    (pm, pp), (jm, jp) = port, ref
    for step, (a, b) in enumerate(zip(pm, jm)):
        assert sorted(a) == sorted(b), step
        # Step 0 starts from equal weights (fp32 sums in another order:
        # 1e-6); later steps start from weights that differ where Adam's
        # sign-like first steps flipped (see PARAM_ATOL): 1e-4.
        tol = 1e-6 if step == 0 else 1e-4
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=tol, err_msg=f"loss, step {step}")
        np.testing.assert_allclose(a["per_item_loss"], b["per_item_loss"], rtol=tol, atol=10 * tol,
                                   err_msg=f"per-item loss, step {step}")
        np.testing.assert_allclose(a["learning_rate"], b["learning_rate"], rtol=1e-6, err_msg=f"rate, step {step}")
        if "grad_norm" in a:
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4, err_msg=f"grad norm, step {step}")
    ref_flat = convert.from_jax_params(jp)
    diffs = []
    for name, v in pp.items():
        np.testing.assert_allclose(v, ref_flat[name].numpy(), atol=param_atol, rtol=1e-5, err_msg=name)
        diffs.append(np.abs(v - ref_flat[name].numpy()).ravel())
    # Most parameters agree to fp32 rounding; only a gradient that is ~0
    # may flip the sign of its first Adam steps.
    assert np.median(np.concatenate(diffs)) < 1e-7


# Adam's first steps are sign-like (|update| ~ lr): a gradient element near
# zero whose sign flips between the two frameworks' fp32 sums moves its
# parameter by up to 2 lr per step in the other direction.  The k-tower bias
# is such a parameter everywhere (its exact gradient is 0: a constant added
# to every key leaves the softmax unchanged).  Bound: twice the sum of the 3
# rates.
PARAM_ATOL = 2 * (5e-4 + 1e-3 + 9.6e-4)


def _launch_counts():
    return (tab.attention_block.fwd_launches, tab.attention_block.bwd_launches,
            tab.attention_block_inference.launches, tmb.mlp_block.fwd_launches,
            tfq.fused_qkv_attention.fwd_launches, tfq.fused_qkv_attention.bwd_launches,
            tfa.flash_attention.fwd_launches, tfa.flash_attention.bwd_launches)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_qkv", "pallas_block", "pallas_block_mlp"])
def test_train_step_trajectory_matches_jax(tiny, impl, monkeypatch):
    """3 fp32 steps: per-step loss and per-item losses (see _compare), the
    rate at 1e-6, and every parameter after the 3 steps (see PARAM_ATOL).
    The port runs under the same impl as JAX; both impl caches are cleared
    around it."""
    batch = _batch()
    monkeypatch.setenv(_IMPL_ENV, impl)
    # JAX's pallas route calls the flash kernel outside interpret mode,
    # which the CPU refuses: point it at the interpret-mode kernel.
    real = jax_flash_attention_mod.flash_attention
    monkeypatch.setattr(jax_flash_attention_mod, "flash_attention",
                        lambda q, k, v, causal=False, interpret=False: real(q, k, v, causal, True))
    port_default_impl.cache_clear()
    try:
        assert port_default_impl() == impl
        before = _launch_counts()
        port = _port_run(tiny, batch)
        assert _launch_counts() == before  # CPU tensors never launch
    finally:
        port_default_impl.cache_clear()
    assert port[0][0]["per_item_loss"].shape == (4,)
    _compare(port, _jax_run(tiny, impl, batch), PARAM_ATOL)


def test_train_step_frozen_encoder_matches_jax(tiny):
    """freeze_encoder: the image tower keeps its values exactly; the rest
    follows JAX's trajectory."""
    batch = _batch(seed=1)
    port = _port_run(tiny, batch, steps=2, freeze_encoder=True)
    _compare(port, _jax_run(tiny, "xla", batch, steps=2, freeze_encoder=True), PARAM_ATOL)
    start = convert.from_jax_params(tiny.params)
    for name, v in port[1].items():
        if name.startswith("visual."):
            np.testing.assert_array_equal(v, start[name].numpy(), err_msg=name)


def test_train_step_grad_norm_matches_jax(tiny):
    batch = _batch(seed=2)
    port = _port_run(tiny, batch, steps=2, log_grad_norm=True)
    assert "grad_norm" in port[0][0]
    _compare(port, _jax_run(tiny, "xla", batch, steps=2, log_grad_norm=True), PARAM_ATOL)


@pytest.mark.parametrize("variant", [{}, {"ignore": True}])
def test_train_step_supervised_loss_matches_jax(tiny, variant):
    """Ground labels through the step: a scalar loss (soft labels, or the
    ``ignore`` variant) and the same trajectory as JAX's."""
    batch, labels = _batch(seed=3), np.array([0, 1, 0, 1], np.int32)
    port = _port_run(tiny, batch, steps=2, labels=labels, use_ground_labels=True, **variant)
    assert port[0][0]["per_item_loss"].shape == ()
    _compare(port, _jax_run(tiny, "xla", batch, steps=2, labels=labels, use_ground_labels=True, **variant),
             PARAM_ATOL)


def test_train_step_runs_the_training_op_and_refuses_grad_cache(tiny, monkeypatch):
    model = _port_model(tiny)
    opt = make_optimizer(warmup_cosine_lr(*SCHEDULE), weight_decay=0.1)
    with pytest.raises(ValueError, match="grad_cache_chunks"):
        make_train_step(model, opt, grad_cache_chunks=0)
    calls = {"train": 0, "infer": 0}
    real_train, real_infer = tab._train_forward, tab.attention_block_inference_reference

    def count_train(*a):
        calls["train"] += 1
        return real_train(*a)

    def count_infer(*a):
        calls["infer"] += 1
        return real_infer(*a)

    monkeypatch.setattr(tab, "_train_forward", count_train)
    monkeypatch.setattr(tab, "attention_block_inference_reference", count_infer)
    state = create_train_state(model, opt)
    images, tokens = (torch.from_numpy(a) for a in _batch())
    make_train_step(model, opt)(state, images, tokens)
    assert calls == {"train": 4, "infer": 0}  # 2 vision + 2 text blocks, training op
    model.eval()
    with torch.inference_mode():
        model.encode_image(images)
    assert calls == {"train": 4, "infer": 2}
    with pytest.raises(ValueError, match="another model"):
        make_train_step(_port_model(tiny), opt)(state, images, tokens)
    # grad_cache_chunks > 1 is the chunked step (training/grad_cache.py):
    # 2 chunks x 2 passes x 4 blocks of the training op, none of the other.
    state, metrics = make_train_step(model, opt, grad_cache_chunks=2)(create_train_state(model, opt), images, tokens)
    assert calls == {"train": 20, "infer": 2}
    assert state.step == 1 and metrics["per_item_loss"].shape == (4,) and torch.isfinite(metrics["loss"])
    with pytest.raises(ValueError, match="another model"):
        make_train_step(_port_model(tiny), opt, grad_cache_chunks=2)(state, images, tokens)


def test_create_train_state_trains_served_model(tiny):
    """build_clip_model gives the eval build; create_train_state puts that
    model in training mode with every parameter requiring grad."""
    cfg = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="float32", seed=0)
    model = build_clip_model(cfg, config_override=port_config(tiny.jcfg), device="cpu")
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    state = create_train_state(model, make_optimizer(warmup_cosine_lr(*SCHEDULE), weight_decay=0.1))
    assert state.model is model and state.step == 0
    assert model.training and all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("normalize_features", [False, True])
def test_classifier_matches_jax(tiny, normalize_features):
    """Logits and features of a padded batch at 1e-4 (fp32 towers, 2
    layers), and the dispatch-only calls return the valid count."""
    rng = np.random.default_rng(5)
    weight = rng.standard_normal((6, tiny.jcfg.embed_dim)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    images = rng.standard_normal((5, 64, 64, 3)).astype(np.float32)
    jclf = JaxClassifier(tiny.jmodel, {"params": jax.tree_util.tree_map(jnp.asarray, tiny.params)},
                         JaxHead.create(jnp.asarray(weight), jnp.asarray(bias)), batch_size=8,
                         normalize_features=normalize_features)
    model = _port_model(tiny).eval().requires_grad_(False)
    clf = Classifier(model, ClassificationHead(torch.from_numpy(weight), torch.from_numpy(bias)), batch_size=8,
                     normalize_features=normalize_features)
    np.testing.assert_allclose(clf.predict_logits(images), jclf.predict_logits(images), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(clf.features(images), jclf.features(images), atol=1e-4, rtol=1e-4)
    logits, n = clf.predict_logits_device(images)
    assert n == 5 and tuple(logits.shape) == (8, 6)
    with pytest.raises(ValueError, match="batch_size"):
        clf.predict_logits(np.zeros((9, 64, 64, 3), np.float32))
    assert clf.replace_head(clf.head).batch_size == 8
