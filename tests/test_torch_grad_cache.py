"""The port's chunked (GradCache) step (``flyp_tpu_torch/training/
grad_cache.py``) against the JAX package's, on the CPU.

The single-device cases of ``tests/test_grad_cache.py``, each on the port:
gradient exactness against the JAX chunk-wise oracle (one ``value_and_grad``
through per-chunk forwards and one full-batch loss) under plain SGD, so the
parameters after the step reflect the gradients directly; the supervised
variants; the AdamW trajectory of the direct step; ``freeze_encoder`` with
``log_grad_norm``; a ModifiedResNet's running statistics chained across the
chunks; the refusals.  A double BatchNorm update in the gradient pass,
planted, must fail the statistics check.  fp32, numpy-seeded inputs.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.ops.losses import clip_loss as jax_clip_loss
from flyp_tpu.training import create_train_state as jax_create_train_state
from flyp_tpu.training import make_chunked_train_step as jax_make_chunked_train_step
from flyp_tpu.training import make_optimizer as jax_make_optimizer
from flyp_tpu.training import warmup_cosine_lr as jax_warmup_cosine_lr
from flyp_tpu_torch.models import CLIPModel, convert
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.training import (create_train_state, grad_cache, make_chunked_train_step, make_optimizer,
                                     make_train_step, warmup_cosine_lr)
from flyp_tpu_torch.training.train_state import AdamWState
from tests.test_grad_cache import _oracle_step, make_batch, tiny_config
from tests.test_torch_resnet import JCFG as RN_JCFG
from tests.test_torch_resnet import assert_stats_close, host

torch.set_num_threads(1)

LR = 0.05


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


class SGD:
    """Plain SGD with the port optimizer's interface: ``p - lr * g`` for
    every parameter not frozen, as the JAX oracle updates them."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return AdamWState(count=torch.zeros((), dtype=torch.int32), mu=[], nu=[])

    @torch.no_grad()
    def update(self, params, grads, state, frozen=None):
        for i, (p, g) in enumerate(zip(params, grads)):
            if not (frozen and frozen[i]):
                p.copy_(p - self.lr * g)
        state.count.add_(1)
        return torch.tensor(self.lr)


def vit():
    """The JAX tests' tiny ViT CLIP: (JAX model, host params)."""
    jmodel = JaxCLIPModel(tiny_config())
    return jmodel, host(init_clip_params(jmodel, 0))


def port(jmodel, params, stats=None) -> CLIPModel:
    model = CLIPModel(port_config(jmodel.config))
    model.load_state_dict(convert.from_jax_params(params, stats), strict=True)
    return model


def rn_batch(b=16, seed=0):
    """Images and captions for the tiny RN config (a 128-token vocabulary)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((b, 16), np.int32)
    for i in range(b):
        n = int(rng.integers(2, 14))
        tokens[i, :n] = rng.integers(1, 126, n)
        tokens[i, n] = 127
    return images, tokens


def assert_params_close(model, jax_params, rtol=1e-5, atol=5e-7):
    """Every parameter against the JAX tree: the JAX tests' tolerances."""
    want = convert.from_jax_params(host(jax_params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=rtol, atol=atol, err_msg=name)


def test_chunked_equals_oracle_sgd():
    """4 chunks of 4: the loss (1e-6) and every parameter after one SGD step
    (rtol 1e-5, atol 5e-7) equal the JAX oracle's."""
    jmodel, params = vit()
    images, tokens = (np.asarray(a) for a in make_batch())
    model = port(jmodel, params)
    opt = SGD(LR)
    state, metrics = make_chunked_train_step(model, opt, chunks=4)(
        create_train_state(model, opt), torch.from_numpy(images), torch.from_numpy(tokens))
    loss_o, params_o = _oracle_step(jmodel, params, jnp.asarray(images), jnp.asarray(tokens), chunks=4, lr=LR)
    np.testing.assert_allclose(float(metrics["loss"]), loss_o, rtol=1e-6)
    assert metrics["per_item_loss"].shape == (16,) and state.step == 1
    assert_params_close(model, params_o)


@pytest.mark.parametrize("variant", ["soft", "ignore", "google_sup"])
def test_chunked_supervised_variants_equal_oracle(variant):
    """Ground labels through the chunked step: a scalar loss and the
    oracle's parameters, at the tolerances above."""
    jmodel, params = vit()
    images, tokens = (np.asarray(a) for a in make_batch())
    labels = np.random.default_rng(1).integers(0, 3, 16)
    kw = dict(ignore=variant == "ignore", google_sup_loss=variant == "google_sup")
    model = port(jmodel, params)
    opt = SGD(LR)
    _, metrics = make_chunked_train_step(model, opt, chunks=2, use_ground_labels=True, **kw)(
        create_train_state(model, opt), torch.from_numpy(images), torch.from_numpy(tokens),
        torch.from_numpy(labels))
    loss_o, params_o = _oracle_step(jmodel, params, jnp.asarray(images), jnp.asarray(tokens), chunks=2, lr=LR,
                                    ground_labels=jnp.asarray(labels), **kw)
    np.testing.assert_allclose(float(metrics["loss"]), loss_o, rtol=1e-6)
    assert metrics["per_item_loss"].shape == ()
    assert_params_close(model, params_o)


def test_chunked_matches_direct_trajectory():
    """The same objective as the direct step: over 3 AdamW steps the chunked
    step's losses track the direct step's (5e-5) and JAX's chunked step's
    (1e-6 at the first step, 1e-4 after, as the port's direct step is held
    to JAX's), through ``make_train_step(..., grad_cache_chunks=2)``."""
    jmodel, params = vit()
    sched = (1e-3, 2, 50)
    jopt = jax_make_optimizer(jax_warmup_cosine_lr(*sched), weight_decay=0.1)
    jstate = jax_create_train_state(jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jstep = jax_make_chunked_train_step(jmodel, jopt, chunks=2, donate=False)
    direct_model, chunked_model = port(jmodel, params), port(jmodel, params)
    opt = make_optimizer(warmup_cosine_lr(*sched), weight_decay=0.1)
    state_d, state_c = create_train_state(direct_model, opt), create_train_state(chunked_model, opt)
    direct = make_train_step(direct_model, opt)
    chunked = make_train_step(chunked_model, opt, grad_cache_chunks=2)
    for seed in range(3):
        images, tokens = make_batch(seed=seed)
        jstate, m_j = jstep(jstate, images, tokens)
        args = torch.from_numpy(np.asarray(images)), torch.from_numpy(np.asarray(tokens))
        state_d, m_d = direct(state_d, *args)
        state_c, m_c = chunked(state_c, *args)
        np.testing.assert_allclose(float(m_c["loss"]), float(m_d["loss"]), rtol=5e-5)
        np.testing.assert_allclose(float(m_c["loss"]), float(m_j["loss"]), rtol=1e-6 if seed == 0 else 1e-4)
        np.testing.assert_allclose(float(m_c["learning_rate"]), float(m_d["learning_rate"]), rtol=1e-6)
    assert state_c.step == 3 and int(state_c.opt_state.count) == 3


def test_chunked_freeze_encoder():
    """The image tower bitwise frozen (no update, no decay), the text tower
    trained; the image tower runs in the feature pass only; the gradient
    norm (of the trained parameters) equals JAX's to 1e-4."""
    jmodel, params = vit()
    images, tokens = make_batch()
    jopt = jax_make_optimizer(jax_warmup_cosine_lr(1e-3, 2, 50), weight_decay=0.1)
    _, m_j = jax_make_chunked_train_step(jmodel, jopt, chunks=2, freeze_encoder=True, donate=False,
                                         log_grad_norm=True)(
        jax_create_train_state(jax.tree_util.tree_map(jnp.asarray, params), jopt), images, tokens)
    model = port(jmodel, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    visual_calls = []
    model.visual.register_forward_hook(lambda *a: visual_calls.append(torch.is_grad_enabled()))
    opt = make_optimizer(warmup_cosine_lr(1e-3, 2, 50), weight_decay=0.1)
    _, metrics = make_chunked_train_step(model, opt, chunks=2, freeze_encoder=True, log_grad_norm=True)(
        create_train_state(model, opt), torch.from_numpy(np.asarray(images)), torch.from_numpy(np.asarray(tokens)))
    assert visual_calls == [False, False]  # pass 1's two chunks, under no_grad
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("visual."):
            assert torch.equal(after[k], v), k
    assert any(not torch.equal(after[k], v) for k, v in before.items() if k.startswith("text."))
    assert float(metrics["grad_norm"]) > 0
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(m_j["grad_norm"]), rtol=1e-4)


def _rn_oracle(jmodel, variables, images, tokens):
    """The JAX test's oracle for the RN step: chunk-wise forward with the
    running statistics chained, one full-batch loss; SGD."""

    def chunk_apply(p, stats, im, tk):
        (f_i, f_t, s), upd = jmodel.apply({"params": p, "batch_stats": stats}, im, tk, train=True,
                                          mutable=["batch_stats"])
        return f_i, f_t, s, upd["batch_stats"]

    def loss_fn(p):
        f1i, f1t, s, stats1 = chunk_apply(p, variables["batch_stats"], images[:8], tokens[:8])
        f2i, f2t, _, stats2 = chunk_apply(p, stats1, images[8:], tokens[8:])
        per_item = jax_clip_loss(jnp.concatenate([f1i, f2i]), jnp.concatenate([f1t, f2t]), s)
        return jnp.mean(per_item), stats2

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), jax.tree_util.tree_map(lambda p, g: p - LR * g, variables["params"], grads), stats


@pytest.fixture(scope="module")
def rn():
    jmodel = JaxCLIPModel(RN_JCFG)
    images, tokens = rn_batch()
    variables = host(jmodel.init(jax.random.key(0), jnp.asarray(images[:2]), jnp.asarray(tokens[:2])))
    return jmodel, variables, (images, tokens), _rn_oracle(jmodel, variables, jnp.asarray(images),
                                                            jnp.asarray(tokens))


def _rn_chunked(rn):
    jmodel, variables, (images, tokens), _ = rn
    model = port(jmodel, variables["params"], variables["batch_stats"])
    opt = SGD(LR)
    _, metrics = make_chunked_train_step(model, opt, chunks=2)(
        create_train_state(model, opt), torch.from_numpy(images), torch.from_numpy(tokens))
    return model, metrics


def _port_rn_oracle(rn):
    """The oracle on the port: chunk-wise forwards under autograd, the
    running statistics chained, the features concatenated, one loss, one
    backward; SGD."""
    jmodel, variables, (images, tokens), _ = rn
    model = port(jmodel, variables["params"], variables["batch_stats"]).train()
    feats = [model(torch.from_numpy(images[i:i + 8]), torch.from_numpy(tokens[i:i + 8])) for i in (0, 8)]
    loss = grad_cache.clip_loss(torch.cat([f[0] for f in feats]), torch.cat([f[1] for f in feats]),
                                feats[0][2]).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(p - LR * g)
    return model, loss.item()


STATS_TOL = dict(rtol=1e-6, atol=5e-7)


def test_chunked_resnet_chains_running_stats(rn):
    """Batch statistics per microbatch, running statistics chained across
    the 2 chunks and written once each.  Against the port's own oracle: the
    loss to 1e-6, the parameters at the JAX tests' rtol 1e-5 / atol 5e-7,
    the statistics bit for bit (pass 1 is the oracle's forward).  Against
    the JAX oracle: the loss to 5e-6 and the parameters to atol 2e-6 (the
    stem conv's gradient comes through BatchNorm's backward over 8 images,
    where the two frameworks' fp32 sums differ by up to 1e-6 after the
    step, as in tests/test_torch_resnet.py), the statistics to rtol 1e-6,
    atol 5e-7 (STATS_TOL: the last stage's statistics carry the sums'
    rounding through every conv before them)."""
    jmodel, variables, _, (loss_o, params_o, stats_o) = rn
    model, metrics = _rn_chunked(rn)
    oracle, loss_p = _port_rn_oracle(rn)
    np.testing.assert_allclose(float(metrics["loss"]), loss_p, rtol=1e-6)
    for (name, p), q in zip(model.named_parameters(), oracle.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-5, atol=5e-7, err_msg=name)
    for (name, b), c in zip(model.named_buffers(), oracle.buffers()):
        assert torch.equal(b, c), name
    np.testing.assert_allclose(float(metrics["loss"]), loss_o, rtol=5e-6)
    assert_params_close(model, params_o, atol=2e-6)
    assert_stats_close(model, stats_o, **STATS_TOL)


def test_double_running_stats_update_fails_the_check(rn, monkeypatch):
    """A gradient pass that writes the running statistics again (the fault
    the step guards against) must fail the statistics check above."""
    monkeypatch.setattr(grad_cache, "running_stats_frozen", lambda model: contextlib.nullcontext(model))
    model, _ = _rn_chunked(rn)
    with pytest.raises(AssertionError):
        assert_stats_close(model, rn[3][2], **STATS_TOL)
    oracle, _ = _port_rn_oracle(rn)
    assert not all(torch.equal(b, c) for b, c in zip(model.buffers(), oracle.buffers()))


def test_chunked_rejects_indivisible_batch():
    jmodel, params = vit()
    model = port(jmodel, params)
    opt = SGD(LR)
    images, tokens = (torch.from_numpy(np.asarray(a)) for a in make_batch())
    with pytest.raises(ValueError, match="divisible by 3 grad-cache chunks"):
        make_chunked_train_step(model, opt, chunks=3)(create_train_state(model, opt), images, tokens)
    with pytest.raises(ValueError, match="chunks"):
        make_chunked_train_step(model, opt, chunks=0)
