"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor ``flyp_tpu``, so on the machine with the card it
runs without the repo's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from flyp_tpu_torch.models import MODEL_CONFIGS, convert
from flyp_tpu_torch.ops import attention_block as tab
from flyp_tpu_torch.serving import ClipServer

pytestmark = pytest.mark.cuda

CLASSNAMES = ["cat", "dog", "school bus"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        rng.standard_normal((B, L, D)).astype(f32),
        (1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
        (rng.standard_normal((3, D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal((3, D))).astype(f32),
        (rng.standard_normal((D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 197, 768, 12, False), (4, 77, 512, 8, True), (3, 13, 128, 2, True),
                                   (1, 197, 768, 12, False), (1, 77, 512, 8, True), (1, 16, 512, 8, True)])
def test_kernel_matches_plain_on_card(card, shape, dtype):
    """fp32 (TF32 off) at 1e-4: only the fp32 summation order differs.
    bf16 at 2e-2 absolute + relative: the kernel rounds where the plain
    version rounds, and another summation order may flip one bf16
    rounding inside q/k/v, p or o (a few ulps of the O(1) outputs)."""
    B, L, D, H, causal = shape
    dt = getattr(torch, dtype)
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(B, L, D, seed=L))
    x = x.to(dt)
    before = tab.attention_block_inference.launches
    with torch.inference_mode():
        out = tab.attention_block_inference(x, *params, H, causal)
        torch.cuda.synchronize()
        ref = tab.attention_block_inference_reference(x, *params, H, causal)
    assert tab.attention_block_inference.launches == before + 1
    assert out.dtype == dt and out.shape == x.shape
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_kernel_refuses_what_it_does_not_take(card):
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(2, 9, 128, seed=0))
    with torch.inference_mode():
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tab.attention_block_inference(x.half(), *params, 2, False)
        with pytest.raises(ValueError, match="head_dim 64"):
            tab.attention_block_inference(x, *params, 4, False)
        with pytest.raises(ValueError, match="is on cpu"):
            tab.attention_block_inference(x, params[0].cpu(), *params[1:], 2, False)


def test_tiny_server_on_card_matches_cpu(card, tmp_path):
    """One tiny CLIP served on the card (kernel) and on the CPU (plain
    version), fp32: logits at 1e-3 (O(10) logits after exp(logit_scale);
    fp32 sums in another order over 2 layers), and the kernel launched
    once per block per chunk."""
    base = MODEL_CONFIGS["ViT-B/16"]
    tiny = dataclasses.replace(
        base, embed_dim=64,
        vision=dataclasses.replace(base.vision, image_size=32, width=128, layers=2, heads=2),
        text=dataclasses.replace(base.text, width=128, heads=2, layers=2),
    )
    cpu = ClipServer.from_checkpoint(None, classnames=CLASSNAMES, compute_dtype="float32", config_override=tiny,
                                     device="cpu", image_buckets=(4, 8), seed=1)
    path = str(tmp_path / "tiny.pt")
    convert.save_torch_checkpoint(path, convert.export_clip_state_dict(cpu.model.state_dict(), tiny))
    before = tab.attention_block_inference.launches
    gpu = ClipServer.from_checkpoint(path, classnames=CLASSNAMES, compute_dtype="float32", config_override=tiny,
                                     device=card, image_buckets=(4, 8))
    images = np.random.default_rng(0).standard_normal((11, 32, 32, 3)).astype(np.float32)
    logits = gpu.classify(images)  # chunks of 8 and a 4-bucket tail
    assert tab.attention_block_inference.launches == before + 2 + 2 * 2
    np.testing.assert_allclose(logits, cpu.classify(images), atol=1e-3, rtol=1e-3)
    caps = ["a photo of a cat.", "a dog", "the school bus"]
    np.testing.assert_allclose(gpu.encode_texts(caps), cpu.encode_texts(caps), atol=1e-4, rtol=1e-4)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


# Kernel vs plain: elementwise (absolute + relative) on activations, relative
# norm on the sums over every row (weight, bias and LN grads).  fp32 differs
# by summation order only; bf16 may also flip a rounding inside q/k/v, e, o,
# do, ds or dq/dk/dv (a few ulps of O(1) values).
TRAIN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 1e-2)}
# B2's sums over rows in the order the plain backward returns them.
B2_SUMS = ("dscale", "dbias", "dwqkv", "dbqkv", "dwout", "dbout")


def _weight_grad_chunk(M, Na, Nb, towers):
    """The rows of one of G4's contraction chunks (``csrc/gemm_sm90.cuh::
    weight_grad_chunk``) for an ``[Na, Nb]`` product over ``towers``."""
    tile_n = 256 if Nb % 256 == 0 else 128 if Nb % 128 == 0 else 64
    tiles = towers * -(-Na // 128) * (Nb // tile_n)
    best = min(range(1, 17), key=lambda s: (-(-tiles * s // 132) / s, s))
    rows = -(-M // best)
    return max(256, -(-rows // 64) * 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(4, 197, 768, 12, False), (4, 77, 512, 8, True), (3, 32, 512, 8, True), (3, 13, 128, 2, True),
     (2, 257, 768, 12, False), (2, 320, 128, 2, True), (2, 577, 1024, 16, False),
     (1, 197, 768, 12, False), (1, 77, 512, 8, True), (1, 16, 512, 8, True),
     (2, 257, 1024, 16, False), (16, 197, 768, 12, False)],
)
def test_training_kernels_match_plain_on_card(card, shape, dtype):
    """B1 on out, o, q, k, v and lse; B2 on dx, dWqkv, dbqkv, dscale,
    dbias, dWout and dbout against the plain backward, and through
    autograd; up to ViT-L/14@336px's 577 keys at D = 1024, ViT-L/14's 257
    (the streamed route) at its width, and at batch 1 (the Fisher's
    per-example passes: M = 197 rows, under two of the GEMM's 128-row
    tiles).  At 16 x 197 = 3,152 rows dWout's chunks are 512 rows, the last
    of them 80."""
    B, L, D, H, causal = shape
    dt = getattr(torch, dtype)
    elem, norm = TRAIN_TOL[dtype]
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(B, L, D, seed=L + 1))
    x = x.to(dt)
    g = torch.from_numpy(np.random.default_rng(L).standard_normal((B, L, D)).astype(np.float32)).to(card).to(dt)
    fwd0, bwd0 = tab.attention_block.fwd_launches, tab.attention_block.bwd_launches
    with torch.no_grad():
        got = tab._fwd_kernel_call(x, *params, H, causal, train=True)
        ref = tab.attention_block_reference(x, *params, H, causal)
    for name, a, b in zip(("out", "o", "q", "k", "v", "lse"), got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name != "lse":
            torch.testing.assert_close(a.float(), b.float(), atol=elem, rtol=elem, msg=name)
    out, o, q, k, v, lse = got
    # lse against the plain lse of the kernel's own q and k (1e-4), and
    # against the plain forward's, whose bf16 q/k may round an element the
    # other way (a score moved by up to ~1e-2).
    qs = (q.float() * 0.125).to(dt)
    own = torch.logsumexp(tab._scores(qs, k, H, causal), dim=-1).transpose(1, 2)
    torch.testing.assert_close(lse, own, atol=1e-4, rtol=0.0, msg="lse (own q, k)")
    torch.testing.assert_close(lse, ref[5], atol=1e-4 if dt == torch.float32 else 1e-2, rtol=0.0, msg="lse")
    ln_s, ln_b, wqkv, _, wout, _ = params
    with torch.no_grad():
        dx, *sums = tab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
        ref_b = tab.attention_block_backward_reference(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
    torch.cuda.synchronize()
    assert dx.dtype == dt and len(sums) == len(B2_SUMS)
    torch.testing.assert_close(dx.float(), ref_b[0].float(), atol=elem, rtol=elem, msg="dx")
    for name, a, b in zip(B2_SUMS, sums, ref_b[1:]):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel(a, b) < norm, (name, _rel(a, b))
    if B * L == 3152:
        assert B * L % _weight_grad_chunk(B * L, D, D, 1) == 80
    assert (tab.attention_block.fwd_launches, tab.attention_block.bwd_launches) == (fwd0 + 1, bwd0 + 1)

    # Through autograd, with every input requiring grad.
    inputs = [x.requires_grad_(True)] + [p.requires_grad_(True) for p in params]
    grads = torch.autograd.grad(tab.attention_block(*inputs, H, causal), inputs, g)
    for name, a, b in zip(("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwout", "dbout"), grads, ref_b):
        assert a.dtype == b.dtype, name
        assert _rel(a, b) < norm, (name, _rel(a, b))
    assert (tab.attention_block.fwd_launches, tab.attention_block.bwd_launches) == (fwd0 + 2, bwd0 + 2)


def test_training_backward_refuses_longer_rows(card):
    """The backward takes rows of at most 1024 keys, its attention passes'
    limit, and refuses a longer one before any launch."""
    B, L, D, H = 1, 1025, 128, 2
    x, ln_s, ln_b, wqkv, _, wout, _ = (torch.from_numpy(a).to(card) for a in _inputs(B, L, D, seed=3))
    q = k = v = torch.zeros_like(x)
    lse = torch.zeros(B, L, H, device=card)
    before = tab.attention_block.bwd_launches
    with pytest.raises(ValueError, match="L <= 1024"):
        tab._bwd_kernel_call(x, x, ln_s, ln_b, wqkv, wout, q, q, k, v, lse, H, False)
    with pytest.raises(TypeError, match="g in x's type"):
        tab._bwd_kernel_call(x.bfloat16(), x, ln_s, ln_b, wqkv, wout, q, q, k, v, lse, H, False)
    assert tab.attention_block.bwd_launches == before


@pytest.mark.parametrize("L", [197, 257])
def test_training_kernels_are_deterministic(card, L):
    """No atomics: two backward runs agree bit for bit, dWout's split sum
    included, on the register route (197 keys) and the streamed one
    (257)."""
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(4, L, 768, seed=2))
    x = x.to(torch.bfloat16).requires_grad_(True)
    params = [p.requires_grad_(True) for p in params]
    g = torch.ones_like(x)
    first = torch.autograd.grad(tab.attention_block(x, *params, 12, False), [x, *params], g)
    second = torch.autograd.grad(tab.attention_block(x, *params, 12, False), [x, *params], g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_inference_op_backward_runs_training_kernels(card):
    """The inference op's grads re-run B1 and B2 and equal the training op's."""
    x, *params = (torch.from_numpy(a).to(card).requires_grad_(True) for a in _inputs(2, 33, 512, seed=4))
    g = torch.ones_like(x)
    launches = (tab.attention_block_inference.launches, tab.attention_block.fwd_launches,
                tab.attention_block.bwd_launches)
    gi = torch.autograd.grad(tab.attention_block_inference(x, *params, 8, True), [x, *params], g)
    assert (tab.attention_block_inference.launches, tab.attention_block.fwd_launches,
            tab.attention_block.bwd_launches) == (launches[0] + 1, launches[1] + 1, launches[2] + 1)
    gt = torch.autograd.grad(tab.attention_block(x, *params, 8, True), [x, *params], g)
    for a, b in zip(gi, gt):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# B4 (MLP block), B5 (fused-QKV attention) and B6 (whole-row attention).

from flyp_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from flyp_tpu_torch.ops import fused_qkv_attention as tfq  # noqa: E402
from flyp_tpu_torch.ops import mlp_block as tmb  # noqa: E402

from flyp_tpu_torch.testing import check_attention  # noqa: E402

# B4 vs plain, elementwise (absolute + relative): fp32 differs by summation
# order only; bf16 may also flip a rounding of h_pre or h (a few ulps of
# O(1) values).  B5/B6 are held to check_attention's bounds.
MLP_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _mlp_params(B, L, D, seed, card):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrays = (
        rng.standard_normal((B, L, D)).astype(f32),
        (1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
        (rng.standard_normal((D, 4 * D)) * (2 * D) ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(4 * D)).astype(f32),
        (rng.standard_normal((4 * D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
    )
    return [torch.from_numpy(a).to(card) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 197, 768), (4, 77, 512), (3, 13, 128), (2, 257, 1024)])
def test_mlp_block_kernel_matches_plain_on_card(card, shape, dtype):
    """B4: out and h_pre against the plain forward; grads through autograd
    against the plain backward on the plain forward's h_pre (relative norm:
    fp32 1e-5, bf16 1e-2)."""
    B, L, D = shape
    dt = getattr(torch, dtype)
    x, *params = _mlp_params(B, L, D, seed=L, card=card)
    x = x.to(dt)
    fwd_tol = MLP_TOL[dtype]
    before = tmb.mlp_block.fwd_launches
    with torch.no_grad():
        out, h_pre = tmb._kernel_forward(x, *params)
        torch.cuda.synchronize()
        ref, ref_h = tmb.mlp_block_reference(x, *params)
    assert tmb.mlp_block.fwd_launches == before + 1
    assert out.dtype == dt and h_pre.dtype == dt and h_pre.shape == (B, L, 4 * D)
    torch.testing.assert_close(h_pre.float(), ref_h.float(), atol=fwd_tol, rtol=fwd_tol)
    torch.testing.assert_close(out.float(), ref.float(), atol=fwd_tol, rtol=fwd_tol)
    g = torch.from_numpy(np.random.default_rng(D).standard_normal((B, L, D)).astype(np.float32)).to(card).to(dt)
    inputs = [x.requires_grad_(True)] + [p.requires_grad_(True) for p in params]
    grads = torch.autograd.grad(tmb.mlp_block(*inputs), inputs, g)
    assert tmb.mlp_block.fwd_launches == before + 2
    ln_s, ln_b, w1, _, w2, _ = params
    with torch.no_grad():
        ref_g = tmb.mlp_block_backward(g, x, ln_s, ln_b, w1, w2, ref_h)
    norm = 1e-5 if dt == torch.float32 else 1e-2
    for name, a, b in zip(("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"), grads, ref_g):
        assert _rel(a, b) < norm, (name, _rel(a, b))


@pytest.mark.parametrize("shape", [(4, 197, 768), (4, 77, 512), (2, 257, 1024), (1, 5, 128)])
def test_mlp_block_hidden_on_card(card, shape):
    """B4 in bf16 over NaN-poisoned outputs with a guard past each end: h
    (the transient between its two products) is the GELU of its own h_pre
    (``check_mlp_hidden``), which the planted fault fails; nothing written
    past the ends; a second launch bit-equal to the first."""
    from flyp_tpu_torch.testing import check_mlp_hidden, mlp_hidden_from_unrounded

    B, L, D = shape
    x, *params = _mlp_params(B, L, D, seed=L + 1, card=card)
    x = x.to(torch.bfloat16)
    bufs = {name: _poisoned(s, torch.bfloat16, card) for name, s in
            (("out", (B, L, D)), ("h_pre", (B, L, 4 * D)), ("hidden", (B, L, 4 * D)))}
    with torch.no_grad():
        out, h_pre = tmb._kernel_forward(x, *params, **{n: b[0] for n, b in bufs.items()})
        torch.cuda.synchronize()
        ref, ref_h = tmb.mlp_block_reference(x, *params)
        for name, (_, guard) in bufs.items():
            assert bool(torch.isnan(guard).all()), name
        torch.testing.assert_close(h_pre.float(), ref_h.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
        check_mlp_hidden(bufs["hidden"][0], h_pre, shape)
        with pytest.raises(AssertionError, match="not the GELU"):
            check_mlp_hidden(mlp_hidden_from_unrounded(x, *params[:4]), h_pre, shape)
        h2 = torch.empty_like(h_pre)
        out2, h_pre2 = tmb._kernel_forward(x, *params, hidden=h2)
    assert torch.equal(out, out2) and torch.equal(h_pre, h_pre2) and torch.equal(bufs["hidden"][0], h2)


def _attention_inputs(op, B, L, H, dt, seed, card):
    rng = np.random.default_rng(seed)
    D = H * 64
    if op == "fused_qkv":
        t = rng.standard_normal((B, L, 3 * D)).astype(np.float32)
        return [torch.from_numpy(t).to(card).to(dt)], torch.from_numpy(
            rng.standard_normal((B, L, D)).astype(np.float32)).to(card).to(dt)
    ts = [torch.from_numpy(rng.standard_normal((B, L, H, 64)).astype(np.float32)).to(card).to(dt) for _ in range(4)]
    return ts[:3], ts[3]


def _attention_ops(op, H, causal):
    """(op, plain forward, plain backward, its launch counters)."""
    if op == "fused_qkv":
        return (lambda t: tfq.fused_qkv_attention(t, H, causal),
                lambda t: tfq.fused_qkv_attention_reference(t, H, causal),
                lambda t, g: (tfq.fused_qkv_attention_backward_reference(t, g, H, causal),),
                tfq.fused_qkv_attention)
    return (lambda q, k, v: tfa.flash_attention(q, k, v, causal),
            lambda q, k, v: tfa.flash_attention_reference(q, k, v, causal),
            lambda q, k, v, g: tfa.flash_attention_backward_reference(q, k, v, g, causal),
            tfa.flash_attention)


def _strided_views(B, L, H, dt, seed, card):
    """q, k, v as head views of one [B, L, 3D] projection (row stride 3D),
    and a cotangent."""
    rng = np.random.default_rng(seed)
    D = H * 64
    qkv = torch.from_numpy(rng.standard_normal((B, L, 3 * D)).astype(np.float32)).to(card).to(dt)
    g = torch.from_numpy(rng.standard_normal((B, L, H, 64)).astype(np.float32)).to(card).to(dt)
    return [qkv[..., t * D:(t + 1) * D].reshape(B, L, H, 64) for t in range(3)], g


# bf16 rows the streamed route takes (above 256 keys): 257, 321 and 577 leave
# one key alone in the last 64-key tile (ViT-L/14 at 224 and 336 px), 320
# ends a tile, 1024 is the ops' limit.
LONG_ROWS = (257, 320, 321, 577, 1024)
# (B, L, H, causal): CLIP's vision and text lengths, the fp32 route's query
# tiles up to 1024, the lengths that end a 16-row warp tile or a 64-key tile
# on both sides of the register route's 256 keys, and the long rows.
ATTENTION_SHAPES = [(4, 197, 12, False), (4, 77, 8, True), (3, 13, 2, True), (2, 577, 4, False), (1, 800, 2, False),
                    (1, 1024, 2, True)] + [(2, L, 2, causal) for L in (1, 17, 63, 65, 197, 255, 256, *LONG_ROWS)
                                           for causal in (False, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
@pytest.mark.parametrize("op", ["fused_qkv", "flash", "flash_strided"])
def test_attention_kernels_match_plain_on_card(card, op, shape, dtype):
    """B5 and B6 (B6 also over strided views of one projection), forward and
    backward, against their plain versions on both routes: o and each of dq,
    dk, dv within check_attention's bounds."""
    B, L, H, causal = shape
    dt = getattr(torch, dtype)
    if op == "flash_strided":
        inputs, g = _strided_views(B, L, H, dt, seed=L, card=card)
    else:
        inputs, g = _attention_inputs(op, B, L, H, dt, seed=L, card=card)
    fn, plain, plain_bwd, counted = _attention_ops("fused_qkv" if op == "fused_qkv" else "flash", H, causal)
    before = (counted.fwd_launches, counted.bwd_launches)
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (counted.fwd_launches, counted.bwd_launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        ref = plain(*inputs)
        ref_grads = plain_bwd(*inputs, g)
    assert out.dtype == dt and out.shape == ref.shape
    where = (op, *shape, dtype)
    check_attention("forward", out, ref, where)
    for a, b in zip(grads, ref_grads):
        assert a.dtype == dt and a.shape == b.shape
    if op == "fused_qkv":  # one dqkv: its q, k and v thirds
        grads, ref_grads = tfq._heads(grads[0], H), tfq._heads(ref_grads[0], H)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        check_attention(name, a, b, where)


def test_flash_kernel_reads_strided_heads(card):
    """q, k, v as views of one [B, L, 3D] projection (as the attention module
    splits it) give what contiguous copies give, bit for bit."""
    B, L, H = 2, 50, 4
    qkv = torch.randn(B, L, 3 * H * 64, device=card, dtype=torch.bfloat16, generator=None)
    views = [qkv[..., t * H * 64:(t + 1) * H * 64].reshape(B, L, H, 64) for t in range(3)]
    g = torch.randn(B, L, H, 64, device=card, dtype=torch.bfloat16)
    leaves = [v.detach().requires_grad_(True) for v in views]
    copies = [v.contiguous().requires_grad_(True) for v in views]
    out_v = tfa.flash_attention(*leaves, True)
    out_c = tfa.flash_attention(*copies, True)
    assert torch.equal(out_v, out_c)
    for a, b in zip(torch.autograd.grad(out_v, leaves, g), torch.autograd.grad(out_c, copies, g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [256, 257])
def test_attention_block_at_the_register_route_boundary(card, L, causal):
    """B3, B1 and B2 in bf16 at 256 keys (the register route's last length)
    and 257 (the streamed route's first), against their plain versions
    at the tolerances of test_kernel_matches_plain_on_card and
    test_training_kernels_match_plain_on_card."""
    B, D, H = 2, 128, 2
    dt = torch.bfloat16
    elem, norm = TRAIN_TOL["bfloat16"]
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(B, L, D, seed=L))
    x = x.to(dt)
    g = torch.from_numpy(np.random.default_rng(L).standard_normal((B, L, D)).astype(np.float32)).to(card).to(dt)
    with torch.no_grad():
        out = tab.attention_block_inference(x, *params, H, causal)
        ref = tab.attention_block_inference_reference(x, *params, H, causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2, msg="B3")
        got = tab._fwd_kernel_call(x, *params, H, causal, train=True)
        ref = tab.attention_block_reference(x, *params, H, causal)
        for name, a, b in zip(("out", "o", "q", "k", "v"), got, ref):
            torch.testing.assert_close(a.float(), b.float(), atol=elem, rtol=elem, msg=f"B1 {name}")
        _, o, q, k, v, lse = got
        torch.testing.assert_close(lse, ref[5], atol=1e-2, rtol=0.0, msg="B1 lse")
        ln_s, ln_b, wqkv, _, wout, _ = params
        dx, *sums = tab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
        ref_b = tab.attention_block_backward_reference(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
    torch.testing.assert_close(dx.float(), ref_b[0].float(), atol=elem, rtol=elem, msg="B2 dx")
    for name, a, b in zip(B2_SUMS, sums, ref_b[1:]):
        assert _rel(a, b) < norm, (name, _rel(a, b))


@pytest.mark.parametrize("L", [197, 77, 300, 257, 577, 1024])
def test_attention_kernels_repeat_bit_for_bit(card, L):
    """Two launches of each of B3, B1, B2, B5 and B6 on the same inputs give
    the same bits (every output element written by one block, no atomics),
    on the register route (L <= 256) and the streamed one (L > 256)."""
    B, D, H, causal, dt = 2, 256, 4, L == 77, torch.bfloat16
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(B, L, D, seed=L))
    x = x.to(dt)
    g = torch.from_numpy(np.random.default_rng(L).standard_normal((B, L, D)).astype(np.float32)).to(card).to(dt)
    ln_s, ln_b, wqkv, _, wout, _ = params
    qkv = torch.from_numpy(np.random.default_rng(L + 1).standard_normal((B, L, 3 * D)).astype(np.float32))
    qkv = qkv.to(card).to(dt)
    q, k, v = tfq._heads(qkv, H)
    g4 = g.reshape(B, L, H, 64)

    def run():
        with torch.no_grad():
            b1 = tab._fwd_kernel_call(x, *params, H, causal, train=True)
            return {"B3": (tab.attention_block_inference(x, *params, H, causal),), "B1": b1,
                    "B2": tab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *b1[1:], H, causal),
                    "B5": (tfq.fused_qkv_attention(qkv, H, causal),
                           tfq.fused_qkv_attention_backward(qkv, g, H, causal)),
                    "B6": (tfa.flash_attention(q, k, v, causal), *tfa.flash_attention_backward(q, k, v, g4, causal))}

    first, second = run(), run()
    for name in first:
        for a, b in zip(first[name], second[name]):
            assert torch.equal(a, b), name


class _PoisonedOutputs:
    """Within ``with``, ``torch.empty`` and ``torch.empty_like`` give a
    NaN-filled view (uint8: 0xFF, NaN in any float view of it) of a buffer
    with a guard of the same fill just past its end: every output, workspace
    and scratch an op allocates.  An element a kernel leaves unwritten stays
    NaN; ``guards_intact`` says whether anything was written past an end."""

    GUARD = 4096

    def __init__(self):
        self.guards = []
        self._real = (torch.empty, torch.empty_like)

    def empty(self, *size, dtype=None, device=None, **_):
        if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
            size = tuple(size[0])
        dtype = dtype or torch.get_default_dtype()
        n = int(np.prod(size))
        buf = torch.full((n + self.GUARD,), 255 if dtype == torch.uint8 else float("nan"), dtype=dtype, device=device)
        self.guards.append(buf[n:])
        return buf[:n].view(size)

    def empty_like(self, t, dtype=None, **_):
        return self.empty(tuple(t.shape), dtype=dtype or t.dtype, device=t.device)

    def guards_intact(self) -> bool:
        return all(bool((g == 255).all() if g.dtype == torch.uint8 else torch.isnan(g).all()) for g in self.guards)

    def __enter__(self):
        torch.empty, torch.empty_like = self.empty, self.empty_like
        return self

    def __exit__(self, *exc):
        torch.empty, torch.empty_like = self._real


def _counts():
    return (tab.attention_block_inference.launches, tab.attention_block.fwd_launches,
            tab.attention_block.bwd_launches, tfq.fused_qkv_attention.fwd_launches,
            tfq.fused_qkv_attention.bwd_launches, tfa.flash_attention.fwd_launches, tfa.flash_attention.bwd_launches)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", LONG_ROWS)
def test_streamed_route_over_poisoned_outputs(card, L, causal):
    """The streamed route through every op that runs it, in bf16: B3, B1, B2,
    B5 and B6 (B6 over strided head views of one projection), every output
    and workspace NaN-poisoned with a guard past its end.  Each kernel's
    outputs against its plain version at the tolerances of
    test_kernel_matches_plain_on_card, test_training_kernels_match_plain_on_card
    and check_attention; nothing written past an end; a second launch equal
    bit for bit; one launch a call on each counter."""
    B, D, H, dt = 2, 128, 2, torch.bfloat16
    elem, norm = TRAIN_TOL["bfloat16"]
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(B, L, D, seed=L + causal))
    x = x.to(dt)
    ln_s, ln_b, wqkv, _, wout, _ = params
    rng = np.random.default_rng(L)
    g = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32)).to(card).to(dt)
    qkv = torch.from_numpy(rng.standard_normal((B, L, 3 * D)).astype(np.float32)).to(card).to(dt)
    views = [qkv[..., t * D:(t + 1) * D].reshape(B, L, H, 64) for t in range(3)]
    g4 = g.reshape(B, L, H, 64)
    before = _counts()

    def run():
        with _PoisonedOutputs() as poison, torch.no_grad():
            b3 = tab.attention_block_inference(x, *params, H, causal)
            b1 = tab._fwd_kernel_call(x, *params, H, causal, train=True)
            b2 = tab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *b1[1:], H, causal)
            b5 = (tfq.fused_qkv_attention(qkv, H, causal), tfq.fused_qkv_attention_backward(qkv, g, H, causal))
            b6 = (tfa.flash_attention(*views, causal), *tfa.flash_attention_backward(*views, g4, causal))
            torch.cuda.synchronize()
        assert poison.guards_intact(), "a kernel wrote past the end of an output"
        return {"B3": (b3,), "B1": b1, "B2": b2, "B5": b5, "B6": b6}

    first, second = run(), run()
    assert _counts() == tuple(c + 2 for c in before)
    for name in first:
        for a, b in zip(first[name], second[name]):
            assert torch.equal(a, b), name

    with torch.no_grad():
        torch.testing.assert_close(first["B3"][0].float(), tab.attention_block_inference_reference(
            x, *params, H, causal).float(), atol=2e-2, rtol=2e-2, msg="B3")
        ref = tab.attention_block_reference(x, *params, H, causal)
        for name, a, b in zip(("out", "o", "q", "k", "v"), first["B1"], ref):
            torch.testing.assert_close(a.float(), b.float(), atol=elem, rtol=elem, msg=f"B1 {name}")
        _, o, q, k, v, lse = first["B1"]
        own = torch.logsumexp(tab._scores((q.float() * 0.125).to(dt), k, H, causal), dim=-1).transpose(1, 2)
        torch.testing.assert_close(lse, own, atol=1e-4, rtol=0.0, msg="B1 lse (own q, k)")
        torch.testing.assert_close(lse, ref[5], atol=1e-2, rtol=0.0, msg="B1 lse")
        ref_b = tab.attention_block_backward_reference(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
        dx, *sums = first["B2"]
        torch.testing.assert_close(dx.float(), ref_b[0].float(), atol=elem, rtol=elem, msg="B2 dx")
        for name, a, b in zip(B2_SUMS, sums, ref_b[1:]):
            assert _rel(a, b) < norm, (name, _rel(a, b))
        where = (L, causal)
        check_attention("B5 forward", first["B5"][0], tfq.fused_qkv_attention_reference(qkv, H, causal), where)
        ref5 = tfq._heads(tfq.fused_qkv_attention_backward_reference(qkv, g, H, causal), H)
        for name, a, b in zip(("dq", "dk", "dv"), tfq._heads(first["B5"][1], H), ref5):
            check_attention(f"B5 {name}", a, b, where)
        check_attention("B6 forward", first["B6"][0], tfa.flash_attention_reference(*views, causal), where)
        ref6 = tfa.flash_attention_backward_reference(*views, g4, causal)
        for name, a, b in zip(("dq", "dk", "dv"), first["B6"][1:], ref6):
            check_attention(f"B6 {name}", a, b, where)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [257, 321, 577])
def test_streamed_route_weighs_the_last_key(card, L, causal):
    """At 257, 321 and 577 keys the last key sits alone in its 64-key tile.
    On inputs where it carries most of each row's weight
    (``testing.edge_key_qkv`` for B5/B6, ``testing.edge_key_block_inputs``
    for B1-B3), a kernel that dropped or mis-masked it would miss by ~3;
    the kernels stay within their bounds, and the planted fault of a row sum
    without the last tile (``testing.forward_without_last_tile``) fails
    check_attention on the same inputs."""
    from flyp_tpu_torch.testing import edge_key_block_inputs, edge_key_qkv, forward_without_last_tile

    B, H, dt = 2, 2, torch.bfloat16
    D = 64 * H
    where = ("edge key", L, causal)
    q, k, v, do = (torch.from_numpy(a).to(card).to(dt) for a in edge_key_qkv(B, L, H, seed=L))
    qkv = torch.cat([t.reshape(B, L, D) for t in (q, k, v)], dim=-1)
    with torch.no_grad():
        ref_o = tfa.flash_attention_reference(q, k, v, causal)
        check_attention("B6 forward", tfa.flash_attention(q, k, v, causal), ref_o, where)
        for name, a, b in zip(("dq", "dk", "dv"), tfa.flash_attention_backward(q, k, v, do, causal),
                              tfa.flash_attention_backward_reference(q, k, v, do, causal)):
            check_attention(f"B6 {name}", a, b, where)
        check_attention("B5 forward", tfq.fused_qkv_attention(qkv, H, causal).reshape(B, L, H, 64), ref_o, where)
        got5 = tfq._heads(tfq.fused_qkv_attention_backward(qkv, do.reshape(B, L, D), H, causal), H)
        ref5 = tfq._heads(tfq.fused_qkv_attention_backward_reference(qkv, do.reshape(B, L, D), H, causal), H)
        for name, a, b in zip(("dq", "dk", "dv"), got5, ref5):
            check_attention(f"B5 {name}", a, b, where)
        with pytest.raises(AssertionError, match="disagrees"):
            check_attention("planted fault", forward_without_last_tile(q, k, v, causal), ref_o, where)

    arrays, cot = edge_key_block_inputs(B, L, D, seed=L)
    x, *params = (torch.from_numpy(a).to(card) for a in arrays)
    x = x.to(dt)
    g = torch.from_numpy(cot).to(card).to(dt)
    ln_s, ln_b, wqkv, _, wout, _ = params
    elem, norm = TRAIN_TOL["bfloat16"]
    with torch.no_grad():
        torch.testing.assert_close(tab.attention_block_inference(x, *params, H, causal).float(),
                                   tab.attention_block_inference_reference(x, *params, H, causal).float(),
                                   atol=2e-2, rtol=2e-2, msg="B3")
        got = tab._fwd_kernel_call(x, *params, H, causal, train=True)
        ref = tab.attention_block_reference(x, *params, H, causal)
        for name, a, b in zip(("out", "o", "q", "k", "v"), got, ref):
            torch.testing.assert_close(a.float(), b.float(), atol=elem, rtol=elem, msg=f"B1 {name}")
        _, o, q, k, v, lse = got
        torch.testing.assert_close(lse, ref[5], atol=1e-2, rtol=0.0, msg="B1 lse")
        dx, *sums = tab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
        ref_b = tab.attention_block_backward_reference(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
    torch.testing.assert_close(dx.float(), ref_b[0].float(), atol=elem, rtol=elem, msg="B2 dx")
    for name, a, b in zip(B2_SUMS, sums, ref_b[1:]):
        assert _rel(a, b) < norm, (name, _rel(a, b))


# ---------------------------------------------------------------------------
# Heads of 80 (ViT-H/14's vision tower: D = 1,280 in 16 heads) on the
# streamed route, and the bits of heads of 64 beside them.

HD80 = 80 ** -0.5
# (B, L, D, causal): batch 8 over every streamed length, ViT-H/14's batch 256
# at its 257 keys, and 8 heads (D = 640, the narrowest block whose D is a
# multiple of 128).
WIDE_SHAPES = [(8, 257, 1280, False), (8, 320, 1280, True), (8, 577, 1280, False), (8, 1024, 1280, False),
               (8, 1024, 1280, True), (256, 257, 1280, False), (4, 300, 640, False)]


def _wide_counts():
    return tuple(dict(c) for c in (tab.attention_block_inference.launches_by_head_dim,
                                   tab.attention_block.fwd_launches_by_head_dim,
                                   tab.attention_block.bwd_launches_by_head_dim))


def _check_block_against_plain(x, params, g, H, causal, b3, b1, b2, scale):
    """B3, B1 and B2's outputs against their plain versions at the
    tolerances of test_kernel_matches_plain_on_card and
    test_training_kernels_match_plain_on_card; lse also against the plain
    lse of B1's own q and k."""
    dt = x.dtype
    elem, norm = TRAIN_TOL["bfloat16"]
    ln_s, ln_b, wqkv, _, wout, _ = params
    with torch.no_grad():
        torch.testing.assert_close(b3.float(), tab.attention_block_inference_reference(x, *params, H, causal).float(),
                                   atol=2e-2, rtol=2e-2, msg="B3")
        ref = tab.attention_block_reference(x, *params, H, causal)
        for name, a, b in zip(("out", "o", "q", "k", "v"), b1, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            torch.testing.assert_close(a.float(), b.float(), atol=elem, rtol=elem, msg=f"B1 {name}")
        _, o, q, k, v, lse = b1
        own = torch.logsumexp(tab._scores((q.float() * scale).to(dt), k, H, causal), dim=-1).transpose(1, 2)
        torch.testing.assert_close(lse, own, atol=1e-4, rtol=0.0, msg="B1 lse (own q, k)")
        torch.testing.assert_close(lse, ref[5], atol=1e-2, rtol=0.0, msg="B1 lse")
        ref_b = tab.attention_block_backward_reference(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
    dx, *sums = b2
    torch.testing.assert_close(dx.float(), ref_b[0].float(), atol=elem, rtol=elem, msg="B2 dx")
    for name, a, b in zip(B2_SUMS, sums, ref_b[1:]):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel(a, b) < norm, (name, _rel(a, b))
    return ref_b


def _block_args(B, L, D, seed, card, arrays=None, cot=None):
    arrays = arrays if arrays is not None else _inputs(B, L, D, seed=seed)
    x, *params = (torch.from_numpy(a).to(card) for a in arrays)
    if cot is None:
        cot = np.random.default_rng(seed).standard_normal((B, L, D)).astype(np.float32)
    return x.to(torch.bfloat16), params, torch.from_numpy(cot).to(card).to(torch.bfloat16)


@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_wide_heads_match_plain_on_card(card, shape):
    """B3, B1 and B2 at heads of 80 in bf16 against their plain versions: up
    to 1,024 keys, causal or not, at ViT-H/14's D = 1,280 (B2's LayerNorm
    rows past 1,024 columns) and batch 256 at its 257 keys; one launch a
    call, counted under heads of 80."""
    B, L, D, causal = shape
    H = D // 80
    x, params, g = _block_args(B, L, D, L + 7, card)
    ln_s, ln_b, wqkv, _, wout, _ = params
    before, counts = _wide_counts(), _counts()[:3]
    with torch.no_grad():
        b3 = tab.attention_block_inference(x, *params, H, causal)
        b1 = tab._fwd_kernel_call(x, *params, H, causal, train=True)
        b2 = tab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *b1[1:], H, causal)
    torch.cuda.synchronize()
    assert _counts()[:3] == tuple(c + 1 for c in counts)
    assert _wide_counts() == tuple({64: c[64], 80: c[80] + 1} for c in before)
    _check_block_against_plain(x, params, g, H, causal, b3, b1, b2, HD80)


@pytest.mark.parametrize("L, D", [(257, 1280), (320, 1280), (1024, 1280), (257, 640), (577, 640)])
def test_wide_heads_over_poisoned_outputs(card, L, D):
    """B3, B1 and B2 at heads of 80 with every output, workspace and scratch
    NaN-poisoned and guarded: nothing left unwritten (the plain versions
    hold every element, dx's and the LayerNorm grads' columns past 1,024
    among them), nothing written past an end, and a second launch equal bit
    for bit."""
    B, H, causal = 2, D // 80, L == 320
    x, params, g = _block_args(B, L, D, L, card)
    ln_s, ln_b, wqkv, _, wout, _ = params

    def run():
        with _PoisonedOutputs() as poison, torch.no_grad():
            b3 = tab.attention_block_inference(x, *params, H, causal)
            b1 = tab._fwd_kernel_call(x, *params, H, causal, train=True)
            b2 = tab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *b1[1:], H, causal)
            torch.cuda.synchronize()
        assert poison.guards_intact(), "a kernel wrote past the end of an output"
        return b3, b1, b2

    first, second = run(), run()
    for a, b in zip([first[0], *first[1], *first[2]], [second[0], *second[1], *second[2]]):
        assert torch.equal(a, b)
    ref_b = _check_block_against_plain(x, params, g, H, causal, *first, HD80)
    if D > 1024:  # the LayerNorm rows' columns a lane of 32 would not reach
        dx, dscale, dbias = first[2][:3]
        elem = TRAIN_TOL["bfloat16"][0]
        torch.testing.assert_close(dx[..., 1024:].float(), ref_b[0][..., 1024:].float(), atol=elem, rtol=elem)
        for a, b in ((dscale, ref_b[1]), (dbias, ref_b[2])):
            assert _rel(a[1024:], b[1024:]) < TRAIN_TOL["bfloat16"][1]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [257, 321, 577])
def test_wide_heads_weigh_the_last_key(card, L, causal):
    """At heads of 80, on inputs where the last key (alone in its 64-key
    tile) carries most of each row's weight (``testing.edge_key_block_inputs``
    at ``head_dim=80``), B1-B3 stay within their bounds, and the planted
    fault of a row sum without the last tile
    (``testing.forward_without_last_tile``) fails check_attention on the
    same q, k, v."""
    from flyp_tpu_torch.testing import edge_key_block_inputs, forward_without_last_tile

    B, D = 2, 640
    H = D // 80
    arrays, cot = edge_key_block_inputs(B, L, D, seed=L, head_dim=80)
    x, params, g = _block_args(B, L, D, L, card, arrays, cot)
    ln_s, ln_b, wqkv, _, wout, _ = params
    with torch.no_grad():
        b3 = tab.attention_block_inference(x, *params, H, causal)
        b1 = tab._fwd_kernel_call(x, *params, H, causal, train=True)
        b2 = tab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *b1[1:], H, causal)
    _check_block_against_plain(x, params, g, H, causal, b3, b1, b2, HD80)
    q, k, v = (t.reshape(B, L, H, 80) for t in b1[2:5])
    ref_o = tfa.flash_attention_reference(q, k, v, causal)
    last = tfa._probs(q, k, causal)[..., -1]  # each row's weight on the last key
    assert float((last[:, :, -1:] if causal else last).min()) > 0.95
    with pytest.raises(AssertionError, match="disagrees"):
        check_attention("planted fault", forward_without_last_tile(q, k, v, causal), ref_o, ("edge key", L, causal))


def _block_digests(tab_module, B, L, D, H, causal, card):
    """SHA-256 prefixes of B3's, B1's and B2's bf16 outputs on inputs drawn
    from a CPU generator seeded with L."""
    import hashlib

    gen = torch.Generator().manual_seed(L)
    x = torch.randn(B, L, D, generator=gen).to(card).to(torch.bfloat16)
    params = [1 + 0.1 * torch.randn(D, generator=gen), 0.1 * torch.randn(D, generator=gen),
              torch.randn(3, D, D, generator=gen) * D ** -0.5, 0.1 * torch.randn(3, D, generator=gen),
              torch.randn(D, D, generator=gen) * D ** -0.5, 0.1 * torch.randn(D, generator=gen)]
    params = [p.to(card) for p in params]
    g = torch.randn(B, L, D, generator=gen).to(card).to(torch.bfloat16)
    ln_s, ln_b, wqkv, _, wout, _ = params
    with torch.no_grad():
        b3 = tab_module.attention_block_inference(x, *params, H, causal)
        b1 = tab_module._fwd_kernel_call(x, *params, H, causal, train=True)
        b2 = tab_module._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *b1[1:], H, causal)
    out = {}
    for name, tensors in (("B3", (b3,)), ("B1", b1), ("B2", b2)):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out[name] = h.hexdigest()[:16]
    return out


# _block_digests as the kernels gave them before the streamed route took a
# head width (an H100 80GB HBM3): heads of 64 keep their bits.
HD64_SHAPES = {197: (8, 197, 768, 12, False), 257: (8, 257, 1024, 16, False)}
HD64_DIGESTS = {
    197: {"B3": "03073c0a101e9ae9", "B1": "c371e61df3f88889", "B2": "4fa91b101362e4f8"},
    257: {"B3": "7c49771543dfe86f", "B1": "e11aa1bcd6b5f33f", "B2": "2ae7fd70c508e119"},
}


@pytest.mark.parametrize("L", sorted(HD64_SHAPES))
def test_head_dim_64_outputs_keep_their_bits(card, L):
    """B3, B1 and B2 at heads of 64 give the bits they gave before the
    streamed route took a head width: ViT-B/16's 197 keys (the register
    route) and ViT-L/14's 257 (the streamed one)."""
    assert _block_digests(tab, *HD64_SHAPES[L], card) == HD64_DIGESTS[L]


def test_attention_kernels_refuse_what_they_do_not_take(card):
    """B5 takes L <= 1024 on the card (ValueError naming the limit); B6
    refuses longer rows with its shape refusal, which the pallas dispatch
    catches; both need head_dim 64."""
    qkv = torch.zeros(1, 1025, 3 * 128, device=card)
    with pytest.raises(ValueError, match="L <= 1024"):
        tfq.fused_qkv_attention(qkv, 2, False)
    q = torch.zeros(1, 1025, 2, 64, device=card)
    with pytest.raises(tfa.UnsupportedShape):
        tfa.flash_attention(q, q, q, False)
    from flyp_tpu_torch.ops.attention import multi_head_attention, xla_attention

    before = tfa.flash_attention.fwd_launches
    torch.testing.assert_close(multi_head_attention(q, q, q, False, impl="pallas"), xla_attention(q, q, q, False))
    assert tfa.flash_attention.fwd_launches == before
    with pytest.raises(ValueError, match="head_dim 64"):
        tfa.flash_attention(torch.zeros(1, 9, 2, 32, device=card), torch.zeros(1, 9, 2, 32, device=card),
                            torch.zeros(1, 9, 2, 32, device=card), False)
    with pytest.raises(ValueError, match="head_dim 64"):
        tfq.fused_qkv_attention(torch.zeros(1, 9, 3 * 128, device=card), 4, False)


# ---------------------------------------------------------------------------
# The measurement probes' kernels (T1-T4).


@pytest.mark.parametrize("shape", [(1000, 768, 640), (512, 768, 2304), (7, 128, 128), (300, 3072, 256),
                                   (200, 768, 512), (8, 64, 384)])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_probe_gemm_matches_plain_on_card(card, kind, shape):
    """T1 over a poisoned output with a guard past its end: int8 exactly the
    int32 product; bf16 into fp32 within the block-FMA bound of its exact
    product (``flyp_tpu_torch.testing.check_gemm``); nothing written past
    the end; a second launch bit-equal."""
    from flyp_tpu_torch.testing import check_gemm
    from flyp_tpu_torch.tools import int8_matmul_probe as tip

    M, K, N = shape
    rng = np.random.default_rng(M)
    if kind == "int8":
        a, b = (torch.from_numpy(rng.integers(-127, 127, s, dtype=np.int8)).to(card) for s in ((M, K), (K, N)))
        sentinel = torch.iinfo(torch.int32).min
        buf = torch.full((M * N + 4096,), sentinel, dtype=torch.int32, device=card)
        out, guard = buf[:M * N].view(M, N), buf[M * N:]
        got = tip.probe_mm(a, b, torch.int32, out=out)
        assert torch.equal(got, tip.probe_mm_reference(a, b, torch.int32))
        assert bool((guard == sentinel).all())
        assert torch.equal(got, tip.probe_mm(a, b, torch.int32))
    else:
        a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(card).to(torch.bfloat16)
                for s in ((M, K), (K, N)))
        out, guard = _poisoned((M, N), torch.float32, card)
        got = tip.probe_mm(a, b, torch.float32, out=out)
        check_gemm("T1 bf16", got, a, b, shape)
        assert bool(torch.isnan(guard).all())
        assert torch.equal(got, tip.probe_mm(a, b, torch.float32))


def test_probe_gemm_refuses_on_card(card):
    from flyp_tpu_torch.tools import int8_matmul_probe as tip

    for (M, K, N), dtype, dim in (((64, 768, 200), torch.int8, "N=200"), ((64, 96, 128), torch.int8, "K=96"),
                                  ((64, 100, 128), torch.bfloat16, "K=100"), ((0, 768, 128), torch.bfloat16, "M=0"),
                                  ((64, 48, 128), torch.bfloat16, "K=48")):
        out_dtype = torch.int32 if dtype == torch.int8 else torch.float32
        with pytest.raises(ValueError, match=dim):
            tip.probe_mm(torch.zeros(M, K, dtype=dtype, device=card), torch.zeros(K, N, dtype=dtype, device=card),
                         out_dtype)


def _poisoned(shape, dtype, device, guard=4096):
    """A NaN-filled output and the NaN guard region just past its end."""
    n = int(np.prod(shape))
    buf = torch.full((n + guard,), float("nan"), dtype=dtype, device=device)
    return buf[:n].view(shape), buf[n:]


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("L", [208, 77, 13, 197, 257, 577])
def test_score_depth_matches_plain_on_card(card, hd, L):
    """T2 over a poisoned output (an element left unwritten fails the
    check), nothing written past its end, two launches bit-equal."""
    from flyp_tpu_torch.tools import mfu_levers as tml

    rng = np.random.default_rng(L)
    q, k = (torch.from_numpy(rng.standard_normal((3, L, 768), dtype=np.float32)).to(card).to(torch.bfloat16)
            for _ in range(2))
    out, guard = _poisoned((3, L, L), torch.float32, card)
    got = tml.score_depth(q, k, hd, out=out)
    assert got is out
    torch.testing.assert_close(got, tml.score_depth_reference(q, k, hd), rtol=1e-5, atol=1e-4)
    assert bool(torch.isnan(guard).all())
    assert torch.equal(got, tml.score_depth(q, k, hd))


@pytest.mark.parametrize("R", [197, 200, 13])
def test_row_gemm_matches_plain_on_card(card, R):
    """T3 over a poisoned output within one bf16 ulp (2^-7 |ref|) plus 1e-4
    (the fp32 sums' order at K=768, for outputs near zero), mean error under
    1e-3; nothing written past its end, two launches bit-equal."""
    from flyp_tpu_torch.tools import mfu_levers as tml

    rng = np.random.default_rng(R)
    x = torch.from_numpy(rng.standard_normal((5, R, 768), dtype=np.float32)).to(card).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((768, 384), dtype=np.float32)).to(card).to(torch.bfloat16)
    out, guard = _poisoned((5, R, 384), torch.bfloat16, card)
    got = tml.row_gemm(x, w, out=out)
    assert got is out
    ref = tml.row_gemm_reference(x, w).float()
    err = (got.float() - ref).abs()
    assert bool((err <= 2.0 ** -7 * ref.abs() + 1e-4).all()) and err.mean().item() < 1e-3
    assert bool(torch.isnan(guard).all())
    assert torch.equal(got, tml.row_gemm(x, w))


def test_probes_refuse_on_card(card):
    """T3 tiles N in 128 columns and reads rows of 16 bytes by TMA (D a
    multiple of 8, so D = 40 is taken); T2 takes hd in 64/128/256 dividing D;
    each refusal a ValueError naming the dimension."""
    from flyp_tpu_torch.tools import mfu_levers as tml

    def bf16(*shape):
        return torch.randn(*shape, device=card).to(torch.bfloat16)

    with pytest.raises(ValueError, match="N=200"):
        tml.row_gemm(bf16(2, 5, 64), bf16(64, 200))
    with pytest.raises(ValueError, match="D=44"):
        tml.row_gemm(bf16(2, 5, 44), bf16(44, 128))
    x, w = bf16(2, 5, 40), bf16(40, 128)
    ref = tml.row_gemm_reference(x, w).float()
    assert bool(((tml.row_gemm(x, w).float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-4).all())
    q = bf16(2, 8, 192)
    with pytest.raises(ValueError, match="hd=128"):
        tml.score_depth(q, q, 128)
    with pytest.raises(ValueError, match="hd=32"):
        tml.score_depth(q, q, 32)


@pytest.mark.parametrize("n", [4096 * 1024, 1000003])
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
def test_adamw_update_matches_plain_on_card(card, mdtype, n):
    """T4 in place: the plain version's uncontracted fp32 formula, so p
    within 1e-6 of the magnitudes of p and of its step (they may cancel)
    and the moments equal (an n not a multiple of 8 takes the
    one-at-a-time tail)."""
    from flyp_tpu_torch.tools import mfu_levers as tml

    dt = getattr(torch, mdtype)
    gen = torch.Generator(device=card).manual_seed(n)
    p = torch.randn(n, generator=gen, device=card)
    m = (0.01 * torch.randn(n, generator=gen, device=card)).to(dt)
    v = (1e-4 * torch.randn(n, generator=gen, device=card) ** 2).to(dt)
    g = torch.randn(n, generator=gen, device=card).to(torch.bfloat16)
    ref = tml.adamw_update_reference(p, m, v, g, 10)
    scale = 1e-6 * (p.abs() + (p - ref[0]).abs())
    got = tml.adamw_update(p, m, v, g, 10)
    assert got[0] is p
    assert bool(((got[0] - ref[0]).abs() <= scale).all())
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


# ---------------------------------------------------------------------------
# The five products of csrc/gemm_sm90.cuh (G1-G5) alone.

from flyp_tpu_torch.ops import gemm_sm90 as tgs  # noqa: E402
from flyp_tpu_torch.testing import check_gemm_product  # noqa: E402

@pytest.mark.parametrize("name", list(tgs.PRODUCTS))
@pytest.mark.parametrize("M, D", [(256 * 197, 768), (64 * 77, 512), (45, 128)])
def test_gemm_products_match_plain_on_card(card, name, M, D):
    """Each product over a NaN-poisoned output against its plain version
    (``check_gemm_product``): at the vision shape, at the text tower's
    M = 4,928 rows (not a multiple of the 128-row tile) and at one ragged
    128-wide tile; a second launch equals the first bit for bit."""
    op = tgs.PRODUCTS[name][0]
    ops = tgs.product_operands(name, M, D, card, seed=M + D)
    shape, dtype = tgs.product_output(name, M, D)
    before = op.launches
    got = op(*ops, out=torch.full(shape, float("nan"), dtype=dtype, device=card))
    torch.cuda.synchronize()
    check_gemm_product(name, got, ops, (name, M, D))
    assert torch.equal(got, op(*ops))
    assert op.launches == before + 2


@pytest.mark.parametrize("name", list(tgs.PRODUCTS))
@pytest.mark.parametrize("M, D, Dv", [(256 * 197, 768, 192), (64 * 32, 768, 192), (45, 512, 320)])
def test_gemm_shard_products_match_plain_on_card(card, name, M, D, Dv):
    """A head shard of an odd number of heads (Dv = 192: ViT-B/16's image
    tower and ViT-L/14's text tower at 4 model ranks; Dv = 320), whose
    column count G1, G3 and G4 tile 64 wide: each product over a
    NaN-poisoned output against its plain version, two launches bit-equal."""
    op = tgs.PRODUCTS[name][0]
    ops = tgs.product_operands(name, M, D, card, seed=M + Dv, Dv=Dv)
    shape, dtype = tgs.product_output(name, M, D, Dv)
    got = op(*ops, out=torch.full(shape, float("nan"), dtype=dtype, device=card))
    torch.cuda.synchronize()
    check_gemm_product(name, got, ops, (name, M, D, Dv))
    assert torch.equal(got, op(*ops))


def test_gemm_products_refuse_what_they_cannot_tile(card):
    y = torch.zeros(64, 200, dtype=torch.bfloat16, device=card)
    w = torch.zeros(3, 200, 200, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="D=200"):
        tgs.qkv_product(y, w, torch.zeros(3, 200, device=card))
    with pytest.raises(TypeError, match="bfloat16"):
        tgs.grad_out_product(torch.zeros(64, 128, device=card), torch.zeros(128, 128, device=card))
    with pytest.raises(ValueError, match="shape"):
        tgs.input_grad_product(torch.zeros(3, 64, 128, dtype=torch.bfloat16, device=card),
                               torch.zeros(3, 256, 256, dtype=torch.bfloat16, device=card))


# ------------------------------------------------------- input pipeline ----

def _host_batches(n, seed):
    """Seeded host batches as the CSV loader yields them: float32 images,
    padded tokens (EOT at varied positions), int32 labels, paths."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        tokens = np.zeros((16, 77), np.int32)
        tokens[:, 0] = 49406
        for i, length in enumerate(rng.integers(4, 40, 16)):
            tokens[i, 1:length] = rng.integers(1, 49000, length - 1)
            tokens[i, length] = 49407
        out.append({"image": rng.standard_normal((16, 64, 64, 3)).astype(np.float32), "tokens": tokens,
                    "label": rng.integers(0, 1000, 16).astype(np.int32), "path": [f"p{b}_{i}" for i in range(16)]})
    return out


def test_prefetch_ring_on_card(card):
    """20 host batches through the pinned ring at size 2 with a slow
    consumer (matmuls on its stream, then a clone of the batch behind them,
    the batch dropped at once): every device copy equals its host batch,
    bf16-cast and token-shrunk, and the ring's slots are refilled, not
    reallocated."""
    from flyp_tpu_torch.data.loader import prefetch_to_device
    from flyp_tpu_torch.tokenizer import shrink_context

    host = _host_batches(20, seed=9)
    refills, allocs = prefetch_to_device.slot_refills, prefetch_to_device.pinned_allocations
    a = torch.randn(4096, 4096, device=card, dtype=torch.bfloat16)
    kept, paths = [], []
    for batch in prefetch_to_device(iter(host), card, size=2, image_dtype=torch.bfloat16):
        for _ in range(24):
            a = (a @ a).clamp_(-1, 1)
        kept.append({k: v.clone() for k, v in batch.items() if isinstance(v, torch.Tensor)})
        paths.append(batch["path"])
        del batch
    torch.cuda.synchronize()
    assert len(kept) == 20
    for got, ref, p in zip(kept, host, paths):
        assert torch.equal(got["image"].cpu(), torch.from_numpy(ref["image"]).to(torch.bfloat16))
        assert torch.equal(got["tokens"].cpu(), torch.from_numpy(shrink_context(ref["tokens"])))
        assert torch.equal(got["label"].cpu(), torch.from_numpy(ref["label"]))
        assert p == ref["path"]
    assert prefetch_to_device.slot_refills - refills == 17  # 20 batches, 3 slots
    widths = {shrink_context(b["tokens"]).shape[1] for b in host}
    assert prefetch_to_device.pinned_allocations - allocs <= 3 * (2 + len(widths))


def _png(arr):
    import struct
    import zlib

    h, w, _ = arr.shape
    raw = np.hstack([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)]).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_native_loader_feeds_a_vit_step_on_card(card, tmp_path):
    """PNG and ``.npy`` rows through the native-backend loader and the ring
    feed one full-width ViT-B/16 step at batch 8 on the default route."""
    from flyp_tpu_torch.config import parse_arguments
    from flyp_tpu_torch.models import build_clip_model
    from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr
    from flyp_tpu_torch.training.data import device_iter, train_loader

    rng = np.random.default_rng(3)
    rows = ["title\tfilepath\tlabel\tguidance\timg_id"]
    for i in range(8):
        arr = rng.integers(0, 256, (200 + 9 * i, 260, 3), dtype=np.uint8)
        path = tmp_path / (f"i{i}.npy" if i % 4 == 0 else f"i{i}.png")
        if i % 4 == 0:
            np.save(path, arr)
        else:
            path.write_bytes(_png(arr))
        rows.append(f"a photo of a dog number {i}.\t{path}\t{i}\t100\t{i}")
    (tmp_path / "t.tsv").write_text("\n".join(rows) + "\n")
    cfg = parse_arguments(["--ft_data", str(tmp_path / "t.tsv"), "--batch-size", "8", "--data_backend", "native",
                           "--model", "ViT-B/16"])
    model = build_clip_model(cfg, device=card)
    opt = make_optimizer(warmup_cosine_lr(1e-5, 1, 10), weight_decay=0.1, moment_dtype="bfloat16")
    state, step = create_train_state(model, opt), make_train_step(model, opt)
    (batch,) = list(device_iter(train_loader(cfg, 224), card, cfg.compute_dtype))
    assert batch["image"].dtype == torch.bfloat16 and batch["image"].shape == (8, 224, 224, 3)
    before = tab.attention_block.fwd_launches, tab.attention_block.bwd_launches
    state, metrics = step(state, batch["image"], batch["tokens"])
    assert torch.isfinite(metrics["loss"]).item()
    assert (tab.attention_block.fwd_launches - before[0], tab.attention_block.bwd_launches - before[1]) == (24, 24)


def _eval_tree(root, classes=20, per_class=2):
    """An ImageNet-style val tree: ``classes`` folders of tinted PNGs."""
    from PIL import Image

    rng = np.random.default_rng(11)
    (root / "ILSVRC2012" / "train").mkdir(parents=True)
    for c in range(classes):
        tint = rng.integers(0, 256, 3)
        for i in range(per_class):
            img = np.clip(tint + rng.integers(-40, 40, (56 + 3 * i, 70, 3)), 0, 255).astype(np.uint8)
            path = root / "ILSVRC2012" / "val" / f"n{c:03d}" / f"{i}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(path)


def test_evaluate_on_card(card, tmp_path):
    """``evaluate`` over a 20-class ImageNet-style tree with a small ViT in
    fp32: B3 in every vision block of every batch, and ``train_stats``
    equal to a CPU run's on the same ``.pt`` (no top-1/top-2 margin of the
    CPU's logits under 1e-3, so equal metrics are expected)."""
    from types import SimpleNamespace

    from flyp_tpu_torch.config import ExperimentConfig
    from flyp_tpu_torch.data.datasets import ImageNet
    from flyp_tpu_torch.data.transforms import eval_transform
    from flyp_tpu_torch.evaluation import Classifier, evaluate
    from flyp_tpu_torch.models import build_clip_model
    from flyp_tpu_torch.models.head import ClassificationHead

    cfg = MODEL_CONFIGS["ViT-B/16"]
    tiny = dataclasses.replace(cfg, embed_dim=64,
                               vision=dataclasses.replace(cfg.vision, image_size=64, width=128, layers=2, heads=2),
                               text=dataclasses.replace(cfg.text, width=128, heads=2, layers=2))
    _eval_tree(tmp_path)
    spec = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="float32", seed=0)
    cpu = build_clip_model(spec, config_override=tiny, device="cpu")
    ckpt = str(tmp_path / "tiny.pt")
    convert.save_torch_checkpoint(ckpt, convert.export_clip_state_dict(cpu.state_dict(), cpu.config))
    weight = torch.from_numpy(np.random.default_rng(5).standard_normal((20, 64)).astype(np.float32) * 30)
    run = ExperimentConfig(eval_datasets=["ImageNet"], data_location=str(tmp_path), batch_size=16, workers=2)
    stats, launches = {}, {}
    for device in ("cpu", card):
        model = build_clip_model(SimpleNamespace(**{**vars(spec), "clip_load": ckpt}), device=device)
        clf = Classifier(model, ClassificationHead(weight).to(device), batch_size=16)
        if device == "cpu":
            ds = ImageNet(preprocess=eval_transform(64), location=str(tmp_path), batch_size=16, num_workers=2)
            top2 = np.sort(np.concatenate([clf.predict_logits(b["image"]) for b in ds.test_loader]), axis=1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
        before = tab.attention_block_inference.launches
        stats[str(device)] = evaluate(clf, run, {})
        launches[str(device)] = tab.attention_block_inference.launches - before
    assert launches == {"cpu": 0, "cuda": tiny.vision.layers * 3}  # 40 images in batches of 16
    assert list(stats["cuda"]) == list(stats["cpu"]) and stats["cuda"] == stats["cpu"]
    assert "ImageNet Class 19 Number" in stats["cuda"]


def test_trainer_resumes_bit_for_bit_on_card(card, tmp_path):
    """``flyp_train`` for 2 epochs on the card (a 2-layer ViT, bf16, bf16
    moments, curriculum over guidance 50 and 100), and the same run stopped
    once by ``--max_steps`` and resumed: both epochs' checkpoints bit-equal,
    B1/B2 launched once per block per step."""
    from types import SimpleNamespace

    from PIL import Image

    from flyp_tpu_torch.config import ExperimentConfig
    from flyp_tpu_torch.data.classnames import openai_classnames
    from flyp_tpu_torch.models import build_clip_model
    from flyp_tpu_torch.training import flyp
    from flyp_tpu_torch.utils import checkpoint

    cfg = MODEL_CONFIGS["ViT-B/16"]
    tiny = dataclasses.replace(cfg, embed_dim=64,
                               vision=dataclasses.replace(cfg.vision, image_size=32, width=128, layers=2, heads=2),
                               text=dataclasses.replace(cfg.text, width=128, heads=2, layers=2))
    _eval_tree(tmp_path)
    rng = np.random.default_rng(4)
    rows = ["title\tfilepath\tlabel\tguidance\timg_id"]
    for i in range(32):
        path = tmp_path / "train" / f"{i}.png"
        path.parent.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (40 + i, 48, 3), dtype=np.uint8)).save(path)
        rows.append(f"a photo of a {openai_classnames[i % 20]}.\t{path}\t{i % 20}\t{(100, 50)[i % 2]}\t{i}")
    (tmp_path / "train.tsv").write_text("\n".join(rows) + "\n")
    spec = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="bfloat16", seed=0)

    def run(name, **flags):
        run_cfg = ExperimentConfig(ft_data=str(tmp_path / "train.tsv"), data_location=str(tmp_path),
                                   train_dataset="ImageNet", template="simple_template", eval_datasets=["ImageNet"],
                                   batch_size=8, epochs=2, curriculum=True, workers=2, adam_moment_dtype="bfloat16",
                                   save=str(tmp_path / name / "ckpt"), log_dir=str(tmp_path / name / "logs"), **flags)
        return flyp.flyp_train(run_cfg, model=build_clip_model(spec, config_override=tiny, device=card))

    before = tab.attention_block.fwd_launches, tab.attention_block.bwd_launches
    assert os.path.basename(run("a")) == "checkpoint_1"
    assert os.path.basename(run("b", max_steps=3)) == "checkpoint_0_step_2"
    assert os.path.basename(run("b")) == "checkpoint_1"
    per_run = 2 * 4 * (tiny.vision.layers + tiny.text.layers)  # 2 epochs of 4 steps
    assert (tab.attention_block.fwd_launches - before[0], tab.attention_block.bwd_launches - before[1]) == (
        2 * per_run, 2 * per_run)
    for epoch in (0, 1):
        a, b = (tmp_path / name / "ckpt" / f"checkpoint_{epoch}" for name in ("a", "b"))
        for file in ("params.pt", "opt_state.pt"):
            ta, tb = checkpoint.load_tensors(str(a), file), checkpoint.load_tensors(str(b), file)
            assert list(ta) == list(tb) and all(torch.equal(ta[k], tb[k]) for k in ta), (epoch, file)
    assert (tmp_path / "a" / "logs" / "stats.tsv").read_text() == (tmp_path / "b" / "logs" / "stats.tsv").read_text()


def _tiny_rn(card_dtype="float32"):
    """A tiny ModifiedResNet CLIP (32 px, width 16, blocks 1-1-1-1, a
    128-wide 2-layer text tower) drawn from seed 0."""
    from types import SimpleNamespace

    cfg = MODEL_CONFIGS["RN50"]
    tiny = dataclasses.replace(cfg, embed_dim=64,
                               vision=dataclasses.replace(cfg.vision, image_size=32, width=16, heads=2,
                                                          resnet_layers=(1, 1, 1, 1)),
                               text=dataclasses.replace(cfg.text, width=128, heads=2, layers=2))
    return SimpleNamespace(model="RN50", clip_load=None, compute_dtype=card_dtype, seed=0), tiny


def _rn_batch(B, seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, 16), np.int64)
    tokens[:, 0] = 49406
    for i, n in enumerate(rng.integers(3, 12, B)):
        tokens[i, 1:n] = rng.integers(1, 49000, n - 1)
        tokens[i, n] = 49407
    return torch.from_numpy(rng.standard_normal((B, 32, 32, 3)).astype(np.float32)), torch.from_numpy(tokens)


def test_resnet_tower_on_card_matches_cpu(card):
    """The tiny RN CLIP on the card (cuDNN convolutions, BatchNorm, B1 in
    the text tower) against the CPU plain version: the fp32 train-mode loss,
    features and updated running statistics (1e-5 / 1e-4), eval-mode
    features; then the image tower's gradients in float64 (1e-3: its
    attention pool computes in fp32).  fp32 gradients are not compared: a
    ReLU after a BatchNorm whose channel is nearly constant over the batch
    masks outputs of rounding-noise size, so a change of summation order
    flips whole masks and moves early gradients by percents, on either
    device."""
    from flyp_tpu_torch.models import build_clip_model
    from flyp_tpu_torch.ops.losses import clip_loss

    spec, tiny = _tiny_rn()
    images, tokens = _rn_batch(8, 0)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal((8, tiny.embed_dim)))
    out = {}
    for dev in ("cpu", card):
        model = build_clip_model(spec, config_override=tiny, device=dev).train()
        with torch.no_grad():
            f, t, s = model(images.to(dev), tokens.to(dev))
            loss = clip_loss(f, t, s).mean().item()
            stats = {k: v.cpu() for k, v in model.named_buffers()}
            model.eval()
            feats = model.encode_image(images.to(dev), normalize=True).cpu()
        tower = build_clip_model(spec, config_override=tiny, device=dev).visual.double().train().requires_grad_(True)
        grads = torch.autograd.grad((tower(images.to(dev).double()) * cot.to(dev)).sum(), list(tower.parameters()))
        out[str(dev)] = (loss, f.cpu(), stats, feats, [g.cpu() for g in grads])
    (l0, f0, s0, e0, g0), (l1, f1, s1, e1, g1) = out["cpu"], out[str(card)]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    torch.testing.assert_close(f1, f0, rtol=1e-4, atol=1e-5)
    for k, v in s0.items():
        torch.testing.assert_close(s1[k], v, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(e1, e0, rtol=1e-4, atol=1e-5)
    for (name, _), a, b in zip(tower.named_parameters(), g1, g0):
        if name != "attnpool.k_proj.bias":  # its exact gradient is 0
            assert float((a - b).norm()) <= 1e-3 * float(b.norm()), name


@pytest.mark.parametrize("tower", ["vit", "resnet"])
def test_chunked_step_on_card_matches_oracle(card, tower):
    """The chunked step (2 chunks, bf16) on the card against the chunk-wise
    oracle on the card (per-chunk forwards under autograd, one loss, one
    backward): the same loss and running statistics bit for bit (pass 1 is
    the oracle's forward), gradients to cosine 0.9999, B1 twice and B2 once
    per block per chunk."""
    from types import SimpleNamespace

    from flyp_tpu_torch.models import build_clip_model
    from flyp_tpu_torch.ops.losses import clip_loss
    from flyp_tpu_torch.training import create_train_state, make_train_step
    from flyp_tpu_torch.training.train_state import AdamWState

    if tower == "resnet":
        spec, tiny = _tiny_rn("bfloat16")
    else:
        cfg = MODEL_CONFIGS["ViT-B/16"]
        tiny = dataclasses.replace(cfg, embed_dim=64,
                                   vision=dataclasses.replace(cfg.vision, image_size=32, width=128, layers=2, heads=2),
                                   text=dataclasses.replace(cfg.text, width=128, heads=2, layers=2))
        spec = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="bfloat16", seed=0)

    class Capture:
        def init(self, params):
            return AdamWState(torch.zeros((), dtype=torch.int32, device=card), [], [])

        def update(self, params, grads, state, frozen=None):
            self.grads = [g.float().clone() for g in grads]
            return torch.zeros((), device=card)

    images, tokens = (t.to(card) for t in _rn_batch(16, 1))
    images = images.to(torch.bfloat16)
    model = build_clip_model(spec, config_override=tiny, device=card)
    oracle = build_clip_model(spec, config_override=tiny, device=card).train().requires_grad_(True)
    cap = Capture()
    blocks = tiny.vision.layers + tiny.text.layers
    before = tab.attention_block.fwd_launches, tab.attention_block.bwd_launches
    _, metrics = make_train_step(model, cap, grad_cache_chunks=2)(create_train_state(model, cap), images, tokens)
    assert (tab.attention_block.fwd_launches - before[0], tab.attention_block.bwd_launches - before[1]) == (
        4 * blocks, 2 * blocks)
    feats = [oracle(images[i:i + 8], tokens[i:i + 8]) for i in (0, 8)]
    loss = clip_loss(torch.cat([f[0] for f in feats]), torch.cat([f[1] for f in feats]), feats[0][2]).mean()
    grads = torch.autograd.grad(loss, list(oracle.parameters()))
    assert float(metrics["loss"]) == loss.item()
    for (name, _), a, b in zip(model.named_parameters(), cap.grads, grads):
        if name != "visual.attnpool.k_proj.bias":
            a, b = a.double().ravel(), b.double().ravel()
            assert float(a @ b) >= 0.9999 * float(a.norm() * b.norm()), name
    for (k, v), w in zip(model.named_buffers(), oracle.buffers()):
        assert torch.equal(v, w), k


def test_fisher_step_on_card_matches_cpu(card):
    """The Fisher step (``training/fisher.py``) of a small fp32 ViT on the
    card (B3 for each example's forward, B1 and B2 for its backward, all at
    batch 1) against the CPU's plain step on the same labels: each
    parameter's sum of squared gradients within 1e-3 of its norm (fp32
    sums in another order, squared), launches exact."""
    from types import SimpleNamespace

    from flyp_tpu_torch.models import build_clip_model
    from flyp_tpu_torch.training.fisher import make_fisher_step

    cfg = MODEL_CONFIGS["ViT-B/16"]
    tiny = dataclasses.replace(cfg, embed_dim=64,
                               vision=dataclasses.replace(cfg.vision, image_size=64, width=128, layers=2, heads=2),
                               text=dataclasses.replace(cfg.text, width=128, heads=2, layers=1))
    spec = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="float32", seed=0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((4, 64, 64, 3)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((64, 5)).astype(np.float32))
    labels = torch.tensor([0, 3, 1, 4])
    out = {}
    for dev in ("cpu", card):
        model = build_clip_model(spec, config_override=tiny, device=dev)
        step = make_fisher_step(model, lambda f, w=W.to(dev): f.float() @ w)
        before = (tab.attention_block_inference.launches, tab.attention_block.fwd_launches,
                  tab.attention_block.bwd_launches)
        sq, n = step(images.to(dev), labels.to(dev))
        torch.cuda.synchronize()
        after = (tab.attention_block_inference.launches, tab.attention_block.fwd_launches,
                 tab.attention_block.bwd_launches)
        out[str(dev)] = ({k: v.cpu() for k, v in sq.items()}, [b - a for a, b in zip(before, after)])
    (ref, cpu_launches), (got, launches) = out["cpu"], out[str(card)]
    assert cpu_launches == [0, 0, 0] and launches == [4 * 2, 4 * 2, 4 * 2]
    for k, v in ref.items():
        assert float((got[k] - v).norm()) <= 1e-3 * float(v.norm()) + 1e-12, k
    assert any(float(v.norm()) > 0 for k, v in ref.items() if k.startswith("visual."))
