"""Heads of 80 (ViT-H/14: D = 1,280 in 16 heads) on the port's main path.

On the card the attention block's kernels take heads of 80 for the whole
block in bf16 over rows of 257-1,024 keys (``csrc/attention.cuh``'s
streamed route at ``kWideHeadDim``) and refuse them everywhere else; the
plain versions beside them take any head width.  This file holds:

* the plain B3 and B1 + B2 (every gradient) at heads of 80 to the JAX
  package's kernels in interpret mode, at L = 257 (the last key alone in
  its 64-key tile), batch 1, two heads (D = 160), causal or not, on random
  and edge-key inputs, at ``test_torch_long_rows.py``'s bounds;
* a tiny ViT-H-shaped ``CLIPModel`` (257 image tokens, heads of 80) on the
  default route against the benchmark's plain reference
  (``benchmark/reference/clip.py``): loss and every gradient;
* the refusals: heads of 80 on the register route, in fp32, in a head
  shard, in B5/B6, and other widths, each a ``ValueError`` naming the rule;
* the kernel calls' spans (``attn.block_fwd``, ``attn.block_bwd``,
  ``attn.block_infer``) with their attributes under a profiler and nothing
  without one, and the launch counters by head width;
* the converter: a ViT image tower 1,280 wide gets 16 heads of 80.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flyp_tpu.ops.attention_block import attention_block as jax_attention_block
from flyp_tpu.ops.attention_block import attention_block_inference as jax_attention_block_inference
from flyp_tpu_torch import testing
from flyp_tpu_torch.models import CLIPModel, convert
from flyp_tpu_torch.models.configs import MODEL_CONFIGS, CLIPConfig, TextConfig, VisionConfig, resolve_model_name
from flyp_tpu_torch.ops import attention_block as tab
from flyp_tpu_torch.ops import flash_attention as tfa
from flyp_tpu_torch.ops import fused_qkv_attention as tfq
from flyp_tpu_torch.utils import profiling
from tests.test_torch_long_rows import BLOCK_NAMES, _jax_vjp, _port_vjp

torch.set_num_threads(1)

L, HEADS, HD = 257, 2, 80
D = HEADS * HD


def _block_inputs(seed, B=1, L=L, D=D):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrays = (
        rng.standard_normal((B, L, D)).astype(f32),
        (1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
        (rng.standard_normal((3, D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal((3, D))).astype(f32),
        (rng.standard_normal((D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
    )
    return arrays, rng.standard_normal((B, L, D)).astype(f32)


def _inputs(edge, seed):
    return testing.edge_key_block_inputs(1, L, D, seed=seed, head_dim=HD) if edge else _block_inputs(seed)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_inference_block_matches_jax_at_hd80(causal, edge):
    """B3's plain version at heads of 80 against the interpret-mode kernel,
    fp32 at 2e-5 (the edge-key outputs, ~3 in size, at 2e-5 relative to
    that)."""
    arrays = _inputs(edge, seed=21 + causal)[0]
    x, *params = (torch.from_numpy(a) for a in arrays)
    with torch.inference_mode():
        out = tab.attention_block_inference(x, *params, HEADS, causal).numpy()
    ref = np.asarray(jax_attention_block_inference(*(jnp.asarray(a) for a in arrays), HEADS, causal, True))
    np.testing.assert_allclose(out, ref, atol=2e-5 * (3.0 if edge else 1.0), rtol=2e-5)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_training_block_matches_jax_at_hd80(causal, edge):
    """B1 + B2's plain versions at heads of 80 (the output and every grad)
    against ``jax.vjp`` of the interpret-mode kernels, fp32: output 2e-5,
    grads 5e-4."""
    arrays, cot = _inputs(edge, seed=31 + causal)
    out, grads = _port_vjp(lambda x, *p: tab.attention_block(x, *p, HEADS, causal), arrays, cot, n_cast=1)
    ref_out, ref_grads = _jax_vjp(lambda x, *p: jax_attention_block(x, *p, HEADS, causal, True), arrays, cot,
                                  n_cast=1)
    np.testing.assert_allclose(out, ref_out, atol=2e-5 * (3.0 if edge else 1.0), rtol=2e-5)
    for name, g, r in zip(BLOCK_NAMES, grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=5e-4, rtol=5e-4, err_msg=name)


def test_edge_key_inputs_weigh_the_last_key_at_hd80():
    """At heads of 80 the edge-key inputs still give the last key a score of
    ~10 and most of every row's weight."""
    arrays, _ = testing.edge_key_block_inputs(1, L, D, seed=5, head_dim=HD)
    _, k, _, qs = tab._project(*(torch.from_numpy(a) for a in arrays[:5]), HEADS)
    s = tab._scores(qs, k, HEADS, False)
    assert float(s[..., -1].min()) == pytest.approx(10.0, abs=1e-3)
    assert float(torch.softmax(s, dim=-1)[..., -1].min()) > 0.95


# A ViT-H/14-shaped model at a tiny size: 224 px at patch 14 (257 tokens),
# two heads of 80 in one image block; the text tower's heads are 64 wide.
TINY_H = {
    "embed_dim": 64,
    "vision": {"image_size": 224, "patch_size": 14, "width": 160, "layers": 1, "heads": 2},
    "text": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 1},
    "compute_dtype": "float32",
}


def test_vit_h_shaped_model_matches_the_reference():
    """The default route (``pallas_block``: B1 and B2's plain versions on the
    CPU) at heads of 80 against the benchmark's plain reference on the same
    seeded weights and batch: the contrastive loss and every parameter's
    gradient, float32 round-off apart."""
    from benchmark import inputs, program, weights
    from benchmark.reference import clip as ref
    from flyp_tpu_torch.ops.attention import _default_impl
    from flyp_tpu_torch.ops.losses import clip_loss

    assert _default_impl() == "pallas_block"
    cpu = torch.device("cpu")
    mix = {"batch": 3, "distinct_batches": 1, "caption_tokens": [6, 20], "vocab_ids": [1, 49000]}
    images, tokens = inputs.train_batches(TINY_H, mix, 7, cpu, torch.float32)[0]
    m = program.model(TINY_H, weights.make(TINY_H, 7, cpu), cpu).train().requires_grad_(True)
    assert m.visual.transformer.block_0.heads == 2 and m.visual.transformer.block_0.attn.qkv_kernel.shape[-1] == 160
    loss = clip_loss(*m(images, program.shrink(tokens))).mean()
    grads = dict(zip([n for n, _ in m.named_parameters()], torch.autograd.grad(loss, list(m.parameters()))))
    loss_r, grads_r = ref.loss_and_grads(weights.make(TINY_H, 7, cpu), images, tokens, TINY_H, rows=3)
    torch.testing.assert_close(loss, loss_r, rtol=1e-6, atol=1e-6)
    assert set(grads) == set(grads_r)
    for n, g in grads.items():  # float32 round-off, summed in other orders
        assert float((g - grads_r[n]).norm()) <= 1e-4 * float(grads_r[n].norm()) + 1e-7, n


def test_vit_h14_config_and_name():
    """The port lists ViT-H/14 at open_clip's widths, and the open_clip name
    selects it with DFN5B's weights."""
    cfg = MODEL_CONFIGS["ViT-H/14"]
    assert (cfg.vision.width, cfg.vision.heads, cfg.vision.layers, cfg.vision.seq_len) == (1280, 16, 32, 257)
    assert cfg.vision.width // cfg.vision.heads == 80
    assert (cfg.text.width, cfg.text.heads, cfg.text.layers, cfg.embed_dim) == (1024, 16, 24, 1024)
    assert resolve_model_name("ViT-H-14-quickgelu") == ("ViT-H/14", "dfn5b")
    with torch.device("meta"):
        model = CLIPModel(cfg)
    assert 0.98e9 < sum(p.numel() for p in model.parameters()) < 0.99e9


# ---------------------------------------------------------------------------
# Refusals: the kernel routes' checks run before anything reaches the card,
# so CPU tensors sent down the device route show them.


def _tensors(B, L, D, dtype=torch.bfloat16, Dv=None):
    Dv = Dv or D
    arrays, _ = _block_inputs(1, B=B, L=L, D=D)
    x, ln_s, ln_b, _, _, _, b_out = (torch.from_numpy(a) for a in arrays)
    wqkv = torch.zeros(3, D, Dv)
    return x.to(dtype), ln_s, ln_b, wqkv, torch.zeros(3, Dv), torch.zeros(Dv, D), b_out


@pytest.fixture
def device_route(monkeypatch):
    """CPU tensors sent down every op's kernel route, where the checks run
    first; a launch that got past them would fail."""
    for module in (tab, tfa, tfq):
        monkeypatch.setattr(module, "_device_route", lambda *a, **k: True)

    def no_launch(*a, **k):
        raise AssertionError("a kernel library was loaded")

    monkeypatch.setattr(tab, "_fwd_lib", no_launch)
    monkeypatch.setattr(tab, "_bwd_lib", no_launch)


RULE = "head_dim 80 runs only the whole block"


@pytest.mark.parametrize("case", ["register_route", "float32", "past_1024", "shard_fwd", "shard_bwd", "tp",
                                  "other_width"])
def test_hd80_refused_where_the_rule_says(device_route, case):
    """Each attention-block entry refuses heads of 80 outside the streamed
    route's rule (bf16, 257-1,024 keys, the whole block) with a
    ``ValueError`` that names the rule, and other widths with one that names
    head_dim 64."""
    if case == "register_route":
        args, match = _tensors(1, 256, 640), RULE
        call = lambda: tab.attention_block(*args, 8)  # noqa: E731
    elif case == "float32":
        args, match = _tensors(1, 257, 640, torch.float32), RULE
        call = lambda: tab.attention_block_inference(*args, 8)  # noqa: E731
    elif case == "past_1024":
        args, match = _tensors(1, 1025, 640), "L <= 1024"
        x, ln_s, ln_b, wqkv, _, wout, _ = args
        lse = torch.zeros(1, 1025, 8)
        call = lambda: tab._bwd_kernel_call(x, x, ln_s, ln_b, wqkv, wout, x, x, x, x, lse, 8, False)  # noqa: E731
    elif case == "shard_fwd":
        args, match = _tensors(1, 257, 1280, Dv=640), RULE
        call = lambda: tab._fwd_kernel_call(*args, 8, False, train=True, partial=True)  # noqa: E731
    elif case == "shard_bwd":
        args, match = _tensors(1, 257, 640), RULE
        x, ln_s, ln_b, wqkv, _, wout, _ = args
        lse = torch.zeros(1, 257, 8)
        call = lambda: tab._bwd_kernel_call(x, x, ln_s, ln_b, wqkv, wout, x, x, x, x, lse, 8, False,  # noqa: E731
                                            add_g=False)
    elif case == "tp":
        args, match = _tensors(1, 257, 640), RULE
        call = lambda: tab.tp_attention_block(*args, 8, group=None)  # noqa: E731
    else:
        args, match = _tensors(1, 257, 768), "head_dim 64"  # 8 heads of 96
        call = lambda: tab.attention_block(*args, 8)  # noqa: E731
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("op", ["fused_qkv", "flash"])
def test_attention_ops_keep_head_dim_64(device_route, op):
    """B5 and B6 keep heads of 64 on every route and refuse 80 by name."""
    if op == "flash":
        q = torch.zeros(1, 257, 2, 80, dtype=torch.bfloat16)
        call = lambda: tfa.flash_attention(q, q, q, False)  # noqa: E731
    else:
        qkv = torch.zeros(1, 257, 3 * 160, dtype=torch.bfloat16)
        call = lambda: tfq.fused_qkv_attention(qkv, 2, False)  # noqa: E731
    with pytest.raises(ValueError, match="head_dim 64"):
        call()


# ---------------------------------------------------------------------------
# Spans and counters of the kernel calls, with the libraries stood in for.


class _FakeLib:
    """A kernel library whose every entry succeeds at once (workspace: 256
    bytes)."""

    def __getattr__(self, name):
        return (lambda *a: 256) if name.endswith("workspace") else (lambda *a: 0)


@pytest.fixture
def fake_kernels(monkeypatch):
    monkeypatch.setattr(tab, "_fwd_lib", lambda: _FakeLib())
    monkeypatch.setattr(tab, "_bwd_lib", lambda: _FakeLib())
    monkeypatch.setattr(tab, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    profiling._LOG.clear()
    yield
    profiling._LOG.clear()


def _calls(B, L, D, heads, causal):
    x, ln_s, ln_b, wqkv, bqkv, wout, bout = _tensors(B, L, D)
    lse = torch.zeros(B, L, heads)
    tab._fwd_kernel_call(x, ln_s, ln_b, wqkv, bqkv, wout, bout, heads, causal, train=False)
    _, o, q, k, v, lse = tab._fwd_kernel_call(x, ln_s, ln_b, wqkv, bqkv, wout, bout, heads, causal, train=True)
    tab._bwd_kernel_call(x, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, heads, causal)


def test_block_spans_record_their_attributes(fake_kernels):
    """Under a profiler each kernel call is one span, named by its kernel,
    with the call's shape, head width, mask and attention route; the
    counters by head width move with the counters."""
    before = (dict(tab.attention_block_inference.launches_by_head_dim),
              dict(tab.attention_block.fwd_launches_by_head_dim), dict(tab.attention_block.bwd_launches_by_head_dim))
    counts = (tab.attention_block_inference.launches, tab.attention_block.fwd_launches,
              tab.attention_block.bwd_launches)
    with profile(activities=[ProfilerActivity.CPU]):
        _calls(2, 257, 1280, 16, False)
        _calls(3, 77, 128, 2, True)
    spans = profiling.span_log()["spans"]
    assert [s["name"] for s in spans] == ["attn.block_infer", "attn.block_fwd", "attn.block_bwd"] * 2
    wide = {"B": 2, "L": 257, "D": 1280, "heads": 16, "head_dim": 80, "causal": False, "route": "stream"}
    text = {"B": 3, "L": 77, "D": 128, "heads": 2, "head_dim": 64, "causal": True, "route": "register"}
    assert [s["attrs"] for s in spans] == [wide] * 3 + [text] * 3
    assert all("device_ms" not in s for s in spans)  # CPU tensors: no stream to time
    assert (tab.attention_block_inference.launches, tab.attention_block.fwd_launches,
            tab.attention_block.bwd_launches) == tuple(c + 2 for c in counts)
    for got, was in zip((tab.attention_block_inference.launches_by_head_dim,
                         tab.attention_block.fwd_launches_by_head_dim, tab.attention_block.bwd_launches_by_head_dim),
                        before):
        assert got == {64: was[64] + 1, 80: was[80] + 1}


def test_block_spans_record_nothing_without_a_profiler(fake_kernels, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    _calls(2, 257, 1280, 16, False)
    assert profiling.span_log()["spans"] == []


def test_block_span_routes():
    """The route attribute: fp32 rows take the fp32 route; bf16 rows the
    register route up to 256 keys and the streamed one past it."""
    with profile(activities=[ProfilerActivity.CPU]):
        for dtype, length in ((torch.float32, 300), (torch.bfloat16, 256), (torch.bfloat16, 257)):
            with tab._span("attn.block_fwd", torch.zeros(1, length, 128, dtype=dtype), 128, 2, False):
                pass
    routes = [s["attrs"]["route"] for s in profiling.span_log()["spans"][-3:]]
    assert routes == ["fp32", "register", "stream"]


# ---------------------------------------------------------------------------
# The converter.


def _openai_state(width, heads, layers=1):
    config = CLIPConfig(embed_dim=32, vision=VisionConfig(image_size=28, patch_size=14, width=width, layers=layers,
                                                          heads=heads),
                        text=TextConfig(context_length=77, vocab_size=100, width=64, heads=1, layers=1))
    model = CLIPModel(config, torch.float32).init_parameters(3)
    return config, model.state_dict(), convert.export_clip_state_dict(model.state_dict(), config)


def test_converter_reads_vit_h_heads():
    """An open_clip-layout state dict whose image tower is 1,280 wide
    converts to 16 heads of 80 (its published head width, not width / 64);
    the tensors come back as they were, and the export round trip gives the
    same state dict.  A given config still wins."""
    config, port_state, openai = _openai_state(1280, 16)
    state, sniffed = convert.convert_clip_state_dict(openai)
    assert sniffed == config and sniffed.vision.heads == 16 and sniffed.text.heads == 1
    assert sorted(state) == sorted(port_state)
    for k, v in state.items():
        assert torch.equal(v, port_state[k]), k
    back = convert.export_clip_state_dict(state, sniffed)
    assert sorted(back) == sorted(openai)
    for k, v in openai.items():
        assert torch.equal(back[k], v), k
    override = CLIPConfig(embed_dim=32, vision=VisionConfig(image_size=28, patch_size=14, width=1280, layers=1,
                                                            heads=20),
                          text=config.text)
    assert convert.convert_clip_state_dict(openai, override)[1].vision.heads == 20
    assert [convert.vision_heads(w) for w in (768, 1024, 1280)] == [12, 16, 16]
