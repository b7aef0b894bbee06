"""The port's CLIP towers, configs and converters against the JAX package.

One tiny CLIP (``__graft_entry__._tiny_config(real_text=True)``: real
vocabulary and context, 2-layer 128-wide towers) initialised by the JAX
package; its params cross to the port through ``from_jax_params`` and
through the OpenAI-layout state dict, and both towers must agree with
``CLIPModel.apply`` in fp32 under every ``FLYP_ATTENTION_IMPL`` value, the
port and JAX under the same one (JAX's Pallas kernels in interpret mode on
the CPU).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import MODEL_CONFIGS as JAX_MODEL_CONFIGS
from flyp_tpu.models import init_clip_params
from flyp_tpu.models import resolve_model_name as jax_resolve_model_name
from flyp_tpu.models.convert import export_clip_state_dict as jax_export_clip_state_dict
import flyp_tpu.ops.flash_attention as jax_flash_attention_mod
from flyp_tpu.ops.attention import _default_impl
from flyp_tpu.tokenizer import shrink_context, tokenize
from flyp_tpu_torch.models import MODEL_CONFIGS, CLIPModel, build_clip_model, convert, resolve_model_name
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.ops.attention import _default_impl as port_default_impl

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 towers: summation order differs over 2 layers


IMPLS = ["auto", "xla", "pallas", "pallas_qkv", "pallas_block", "pallas_block_mlp"]


def set_impl(monkeypatch, impl):
    """Both packages under ``impl``; their cached choices cleared (the
    caller clears them again when done).  JAX's ``pallas`` route calls the
    flash kernel outside interpret mode, which the CPU refuses, so it is
    pointed at the interpret-mode kernel."""
    monkeypatch.setenv("FLYP_ATTENTION_IMPL", impl)
    real = jax_flash_attention_mod.flash_attention
    monkeypatch.setattr(jax_flash_attention_mod, "flash_attention",
                        lambda q, k, v, causal=False, interpret=False: real(q, k, v, causal, True))
    _default_impl.cache_clear()
    port_default_impl.cache_clear()


def clear_impl():
    _default_impl.cache_clear()
    port_default_impl.cache_clear()


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(
        embed_dim=d["embed_dim"],
        vision=VisionConfig(**d["vision"]),
        text=TextConfig(**d["text"]),
        logit_scale_init=d["logit_scale_init"],
    )


@pytest.fixture(scope="module")
def tiny():
    jcfg = _tiny_config(real_text=True)
    jmodel = JaxCLIPModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jmodel, 0))
    model = CLIPModel(port_config(jcfg))
    model.load_state_dict(convert.from_jax_params(params), strict=True)
    model.eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    tokens = tokenize(["a photo of a cat.", "a dog", "the quick brown fox jumps over the lazy dog " * 2])
    return SimpleNamespace(jcfg=jcfg, jmodel=jmodel, params=params, model=model, images=images, tokens=tokens)


def test_model_configs_equal_jax():
    # The port lists one model the JAX package does not: ViT-H/14, whose
    # heads of 80 only the port's kernels take.
    assert sorted(MODEL_CONFIGS) == sorted([*JAX_MODEL_CONFIGS, "ViT-H/14"])
    for name, cfg in JAX_MODEL_CONFIGS.items():
        assert dataclasses.asdict(MODEL_CONFIGS[name]) == dataclasses.asdict(cfg), name
        assert MODEL_CONFIGS[name].vision.is_vit == cfg.vision.is_vit
    for name in list(JAX_MODEL_CONFIGS) + ["ViT-B-16", "ViT-L-14", "ViT-B-32"]:
        assert resolve_model_name(name) == jax_resolve_model_name(name)
    with pytest.raises(ValueError):
        resolve_model_name("ViT-X/99")


def test_from_jax_params_loads_strictly(tiny):
    sd = convert.from_jax_params(tiny.params)
    own = tiny.model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    flat = jax.tree_util.tree_flatten_with_path(tiny.params)[0]
    assert len(flat) == len(sd)


def test_openai_layout_loads_strictly_and_round_trips(tiny):
    openai = jax_export_clip_state_dict(tiny.params)
    state, cfg = convert.convert_clip_state_dict(openai)
    assert cfg == port_config(tiny.jcfg)
    direct = convert.from_jax_params(tiny.params)
    assert sorted(state) == sorted(direct)
    for k in state:
        assert torch.equal(state[k], direct[k]), k
    model = CLIPModel(cfg)
    model.load_state_dict(state, strict=True)
    back = convert.export_clip_state_dict(model.state_dict(), cfg)
    assert sorted(back) == sorted(openai)
    for k, v in openai.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("impl", IMPLS)
def test_towers_match_jax(tiny, impl, monkeypatch):
    set_impl(monkeypatch, impl)
    try:
        assert port_default_impl() == ("pallas_block" if impl == "auto" else impl)
        variables = {"params": tiny.params}
        apply = tiny.jmodel.apply
        shrunk = shrink_context(tiny.tokens)
        assert shrunk.shape[1] < tiny.tokens.shape[1]
        ref_img = np.asarray(apply(variables, jnp.asarray(tiny.images), method="encode_image"))
        ref_txt = np.asarray(apply(variables, jnp.asarray(tiny.tokens), method="encode_text"))
        ref_short = np.asarray(apply(variables, jnp.asarray(shrunk), method="encode_text"))
        ref_i, ref_t, ref_s = apply(variables, jnp.asarray(tiny.images), jnp.asarray(tiny.tokens))
        m = tiny.model
        with torch.inference_mode():
            images, tokens = torch.from_numpy(tiny.images), torch.from_numpy(tiny.tokens)
            np.testing.assert_allclose(m.encode_image(images).numpy(), ref_img, **TOL)
            np.testing.assert_allclose(m.encode_text(tokens).numpy(), ref_txt, **TOL)
            np.testing.assert_allclose(m.encode_text(torch.from_numpy(shrunk)).numpy(), ref_short, **TOL)
            i, t, s = m(images, tokens)
            np.testing.assert_allclose(i.numpy(), np.asarray(ref_i), **TOL)
            np.testing.assert_allclose(t.numpy(), np.asarray(ref_t), **TOL)
            np.testing.assert_allclose(float(s), float(ref_s), rtol=1e-6)
            # Single-tower calls return unnormalised features.
            np.testing.assert_allclose(m(images, None).numpy(), ref_img, **TOL)
            np.testing.assert_allclose(m(None, tokens).numpy(), ref_txt, **TOL)
    finally:
        clear_impl()


def test_random_init_is_seeded_and_clip_distributed(tiny):
    cfg = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="float32", seed=3)
    override = port_config(tiny.jcfg)
    a = build_clip_model(cfg, config_override=override, device="cpu")
    b = build_clip_model(cfg, config_override=override, device="cpu")
    c = build_clip_model(SimpleNamespace(**{**vars(cfg), "seed": 4}), config_override=override, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.visual.proj, c.visual.proj)
    assert not any(p.requires_grad for p in a.parameters())
    D = override.vision.width
    assert abs(a.visual.transformer.block_0.attn.qkv_kernel.std().item() * D ** 0.5 - 1) < 0.05
    assert abs(a.text.token_embedding.std().item() / 0.02 - 1) < 0.05
    assert torch.equal(a.visual.ln_pre.scale, torch.ones(D))
    assert float(a.logit_scale) == pytest.approx(override.logit_scale_init)


def test_unported_paths_raise(tmp_path):
    # The ModifiedResNet towers are ported: every RN config builds (on the
    # meta device, without memory), its BatchNorm statistics as buffers.
    for name, config in MODEL_CONFIGS.items():
        if config.vision.is_vit:
            continue
        with torch.device("meta"):
            model = CLIPModel(config)
        stats = dict(model.named_buffers())
        assert "visual.bn1.mean" in stats and "visual.layer1_0.downsample_bn.var" in stats, name
        assert model.visual.attnpool.positional_embedding.shape == ((config.vision.image_size // 32) ** 2 + 1,
                                                                    config.vision.width * 32), name
    cfg = SimpleNamespace(model="ViT-B/16", clip_load=str(tmp_path), compute_dtype="float32", seed=0)
    with pytest.raises(ValueError, match="not a checkpoint directory of this package"):
        build_clip_model(cfg, device="cpu")  # a directory without the port's meta.json
