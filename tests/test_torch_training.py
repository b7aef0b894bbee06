"""The port's loss, schedules, AdamW and metrics against the JAX package.

Same numpy inputs through ``flyp_tpu.ops.losses.clip_loss``,
``flyp_tpu.training.{schedules,train_state}`` (optax) and
``flyp_tpu.evaluation.metrics`` and their counterparts in
``flyp_tpu_torch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flyp_tpu.evaluation.metrics import macro_f1 as jax_macro_f1
from flyp_tpu.evaluation.metrics import topk_accuracy as jax_topk_accuracy
from flyp_tpu.ops.losses import clip_loss as jax_clip_loss
from flyp_tpu.training.schedules import make_scheduler as jax_make_scheduler
from flyp_tpu.training.schedules import warmup_cosine_lr as jax_warmup_cosine_lr
from flyp_tpu.training.train_state import make_optimizer as jax_make_optimizer
from flyp_tpu_torch.evaluation import macro_f1, topk_accuracy
from flyp_tpu_torch.ops.losses import clip_loss
from flyp_tpu_torch.training import make_optimizer, make_scheduler, warmup_cosine_lr

torch.set_num_threads(1)

VARIANTS = {
    "infonce": dict(labels=False),
    "ignore": dict(labels=True, ignore=True),
    "google_sup_loss": dict(labels=True, google_sup_loss=True),
    "soft_labels": dict(labels=True),
}


def _features(seed=0, B=8, D=16):
    rng = np.random.default_rng(seed)
    img, txt = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    labels = np.array([0, 1, 0, 2, 1, 3, 3, 0], np.int32)[:B]
    return img, txt, np.float32(np.exp(2.6592600369589688)), labels


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_clip_loss_matches_jax(variant):
    """Values and grads (features and scale) at 1e-6: fp32 on both sides,
    the same formulas."""
    opts = dict(VARIANTS[variant])
    use_labels = opts.pop("labels")
    img, txt, scale, labels = _features()

    def jax_sum(i, t, s):
        return jnp.sum(jax_clip_loss(i, t, s, jnp.asarray(labels) if use_labels else None, **opts))

    ref = np.asarray(jax_clip_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale),
                                   jnp.asarray(labels) if use_labels else None, **opts))
    ref_grads = jax.grad(jax_sum, argnums=(0, 1, 2))(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale))

    i, t, s = (torch.tensor(a, requires_grad=True) for a in (img, txt, scale))
    out = clip_loss(i, t, s, torch.from_numpy(labels).long() if use_labels else None, **opts)
    assert out.shape == ref.shape  # per-item for InfoNCE, a scalar for the supervised variants
    grads = torch.autograd.grad(out.sum(), (i, t, s))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6, rtol=1e-6)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)


def test_clip_loss_refuses_two_variants():
    img, txt, scale, labels = (torch.from_numpy(np.asarray(a)) for a in _features())
    with pytest.raises(ValueError, match="only one"):
        clip_loss(img, txt, scale, labels.long(), ignore=True, google_sup_loss=True)


@pytest.mark.parametrize("name", ["default", "drestart", "default_slower", "crestart"])
def test_schedules_match_jax(name):
    """Every step of two epochs and a half, at 1e-6 relative and 1e-7 of the
    base rate absolute: an fp32 ulp of the cosine near the schedule's end."""
    args = (name, 3e-4, 7, 4, 10)
    jax_fn, fn = jax_make_scheduler(*args), make_scheduler(*args)
    steps = np.arange(0, 45)
    ref = np.asarray([float(jax_fn(s)) for s in steps])
    out = np.asarray([float(fn(int(s))) for s in steps])
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=3e-11)
    # A step held as a tensor gives the same values, as a tensor.
    np.testing.assert_allclose(fn(torch.arange(45, dtype=torch.int32)).numpy(), ref, rtol=1e-6, atol=3e-11)
    with pytest.raises(ValueError, match="invalid scheduler"):
        make_scheduler("cosine_typo", 1e-3, 1, 1, 1)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_matches_optax(moment_dtype):
    """3 updates of a random tree against the JAX package's optax optimizer:
    parameters at 1e-6, moments at 1e-6 relative (fp32: the sums round in
    another order) or one bf16 ulp (2**-8) when stored in bf16; the rate is
    schedule(count) with count from 0."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (7,), "c": ()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    schedule_args = (1e-2, 2, 10)

    jopt = jax_make_optimizer(jax_warmup_cosine_lr(*schedule_args), weight_decay=0.1, moment_dtype=moment_dtype)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    opt = make_optimizer(warmup_cosine_lr(*schedule_args), weight_decay=0.1, moment_dtype=moment_dtype)
    tparams = [torch.tensor(params[k]) for k in shapes]
    state = opt.init(tparams)
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        lr = opt.update(tparams, [torch.tensor(g[k]) for k in shapes], state)
        assert float(lr) == pytest.approx(float(jstate.hyperparams["learning_rate"]), rel=1e-6)
    assert int(state.count) == 3
    for k, p in zip(shapes, tparams):
        np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), atol=1e-6, rtol=1e-6, err_msg=k)
    adam = jstate.inner_state[0]
    tol = 1e-6 if moment_dtype is None else 2 ** -8
    for k, m, v in zip(shapes, state.mu, state.nu):
        assert m.dtype == (torch.float32 if moment_dtype is None else torch.bfloat16)
        np.testing.assert_allclose(m.float().numpy(), np.asarray(adam.mu[k], np.float32), rtol=tol, atol=1e-8)
        np.testing.assert_allclose(v.float().numpy(), np.asarray(adam.nu[k], np.float32), rtol=tol, atol=1e-8)


def test_adamw_frozen_parameters_keep_their_values():
    opt = make_optimizer(warmup_cosine_lr(1e-2, 1, 10), weight_decay=0.1)
    params = [torch.ones(3), torch.ones(2)]
    state = opt.init(params)
    opt.update(params, [torch.ones(3), torch.zeros(2)], state, frozen=[False, True])
    assert torch.equal(params[1], torch.ones(2)) and not torch.equal(params[0], torch.ones(3))
    assert torch.equal(state.mu[1], torch.zeros(2))
    with pytest.raises(ValueError, match="moment_dtype"):
        make_optimizer(warmup_cosine_lr(1e-2, 1, 10), 0.1, moment_dtype="float16")


def test_metrics_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((50, 7)).astype(np.float32)
    labels = rng.integers(0, 9, 50)
    assert topk_accuracy(logits, labels, (1, 3, 5)) == jax_topk_accuracy(logits, labels, (1, 3, 5))
    preds = logits.argmax(1)
    for num_classes in (None, 12):
        assert macro_f1(preds, labels, num_classes) == pytest.approx(jax_macro_f1(preds, labels, num_classes),
                                                                     abs=1e-12)
