"""The port pins the model's mode where the JAX package pins ``train``.

JAX passes ``train`` explicitly: ``False`` where the zero-shot head is built,
in the classifier and in the server, ``True`` in the train step.  The port's blocks
pick the attention op from the module's ``training`` flag, so those callers
run the model in eval (or training) mode whatever the caller left it in, and
restore the caller's mode afterwards.  All on the CPU in bf16, on the tiny
CLIP of ``__graft_entry__._tiny_config(real_text=True)`` under the default
fused-block route (JAX's Pallas kernels in interpret mode).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flyp_tpu.evaluation.zeroshot import get_zeroshot_classifier as jax_get_zeroshot_classifier
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.ops.attention import _default_impl
from flyp_tpu.templates import simple_template as jax_simple_template
from flyp_tpu_torch.evaluation import Classifier, get_zeroshot_classifier
from flyp_tpu_torch.models import CLIPModel, convert, pinned_mode
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.ops import attention_block as tab
from flyp_tpu_torch.ops.attention import _default_impl as port_default_impl
from flyp_tpu_torch.serving import ClipServer
from flyp_tpu_torch.templates import simple_template
from flyp_tpu_torch.tokenizer import shrink_context, tokenize
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr

torch.set_num_threads(1)

CLASSNAMES = ["cat", "dog", "school bus", "golden retriever", "tench"]


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(
        embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
        logit_scale_init=d["logit_scale_init"],
    )


@pytest.fixture
def fused_route(monkeypatch):
    """Both packages on the default fused-block route."""
    monkeypatch.setenv("FLYP_ATTENTION_IMPL", "pallas_block")
    _default_impl.cache_clear()
    port_default_impl.cache_clear()
    yield
    _default_impl.cache_clear()
    port_default_impl.cache_clear()


@pytest.fixture(scope="module")
def tiny():
    jcfg = _tiny_config(real_text=True)
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(JaxCLIPModel(jcfg), 3))
    return jcfg, params


def _port_model(tiny):
    jcfg, params = tiny
    model = CLIPModel(port_config(jcfg), compute_dtype=torch.bfloat16)
    model.load_state_dict(convert.from_jax_params(params), strict=True)
    return model


def _optimizer():
    return make_optimizer(warmup_cosine_lr(1e-3, 2, 10), weight_decay=0.1)


def _modes(model):
    return [m.training for m in model.modules()]


def test_head_after_create_train_state_matches_jax_eval_head(tiny, fused_route):
    """A head built right after ``create_train_state`` (the model in training
    mode) equals JAX's ``train=False`` head at the bf16 bound of
    ``test_torch_attention_block.py`` (3e-2 absolute + relative, mean abs
    under 2e-3, on the unit-norm class embeddings), and equals bit for bit
    the head built from the same model in eval mode: the inference op's
    rounding, not the training op's."""
    jcfg, params = tiny
    jmodel = JaxCLIPModel(jcfg, compute_dtype=jnp.bfloat16)
    ref = np.asarray(jax_get_zeroshot_classifier(jmodel, {"params": params}, CLASSNAMES,
                                                 jax_simple_template).weight, np.float32)
    model = _port_model(tiny)
    create_train_state(model, _optimizer())
    assert model.training
    head = get_zeroshot_classifier(model, CLASSNAMES, simple_template)
    assert model.training
    ours = head.weight.detach().float().numpy()
    scale = float(np.exp(np.asarray(params["logit_scale"], np.float32)))
    np.testing.assert_allclose(ours / scale, ref / scale, atol=3e-2, rtol=3e-2)
    assert np.abs(ours / scale - ref / scale).mean() < 2e-3
    model.eval()
    eval_head = get_zeroshot_classifier(model, CLASSNAMES, simple_template)
    assert torch.equal(head.weight, eval_head.weight)


@pytest.mark.parametrize("start", ["train", "eval", "mixed"])
def test_callers_restore_the_model_mode(tiny, fused_route, monkeypatch, start):
    """``get_zeroshot_classifier``, ``Classifier``, ``ClipServer`` and the
    train step each leave every submodule's flag as they found it, from a
    model in training mode, in eval mode, or in a mix; the step takes the
    training op (B1's plain version) in every block even from eval mode,
    and the others the inference op (B3's)."""
    model = _port_model(tiny)
    opt = _optimizer()
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    if start == "eval":
        model.eval()
    elif start == "mixed":
        model.visual.transformer.block_0.eval()
    before = _modes(model)
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
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    layers = model.config.vision.layers + model.config.text.layers

    head = get_zeroshot_classifier(model, CLASSNAMES, simple_template)
    assert _modes(model) == before and calls == {"train": 0, "infer": model.config.text.layers}
    Classifier(model, head, batch_size=2).predict_logits(images)
    assert _modes(model) == before and calls["train"] == 0
    srv = ClipServer(model, head=head, image_buckets=(2,))
    srv.classify(images)
    srv.encode_texts(["a photo of a cat."])
    assert _modes(model) == before and calls["train"] == 0
    tokens = torch.from_numpy(shrink_context(tokenize(["a cat", "a dog"])))
    infer = calls["infer"]
    step(state, torch.from_numpy(images).to(torch.bfloat16), tokens)
    assert _modes(model) == before and calls == {"train": layers, "infer": infer}

    with pinned_mode(model, train=False):
        assert not any(_modes(model))
    assert _modes(model) == before
