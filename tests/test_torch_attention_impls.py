"""The port's B4, B5 and B6 ops and the attention dispatch against the JAX
package.

Same inputs (numpy, seeded) through the JAX ops in interpret mode (their
CPU route to the TPU kernels) and through the port's ops, whose CPU route is
the plain PyTorch version of each kernel:
``flyp_tpu.ops.flash_attention.flash_attention`` (B6),
``flyp_tpu.ops.fused_qkv_attention.fused_qkv_attention`` (B5) and
``flyp_tpu.ops.mlp_block.mlp_block`` (B4).  Grads come from ``jax.vjp`` and
``torch.autograd.grad`` with the same numpy cotangent.

Bounds: fp32 within 1e-5 absolute plus 1e-5 relative (only fp32 summation
orders differ; the relative term covers B4's LN-parameter grads, sums over
every row of magnitude ~10).
bf16: both sides round at the same points, but an fp32 sum in another order
can flip a bf16 rounding (2**-8 relative) of p, o, ds or a grad, and the
flip propagates; mean absolute error at most 2e-3 (PR 1's bound), each
element within 5e-2 absolute plus 5e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.ops import attention as jax_attention_mod
from flyp_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flyp_tpu.ops.fused_qkv_attention import fused_qkv_attention as jax_fused_qkv_attention
from flyp_tpu.ops.mlp_block import mlp_block as jax_mlp_block
from flyp_tpu_torch.ops import attention as port_attention_mod
from flyp_tpu_torch.ops import flash_attention as tfa
from flyp_tpu_torch.ops import fused_qkv_attention as tfq
from flyp_tpu_torch.ops import mlp_block as tmb

torch.set_num_threads(1)

HEADS, HEAD_DIM = 2, 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _assert_close(got, ref, dtype, name):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg=name)
        return
    assert np.abs(got - ref).mean() <= 2e-3, (name, np.abs(got - ref).mean())
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2, err_msg=name)


def _jax_vjp(fn, arrays, cot, dtype):
    jt = DTYPES[dtype][0]
    out, vjp = jax.vjp(fn, *(jnp.asarray(a).astype(jt) for a in arrays))
    grads = vjp(jnp.asarray(cot).astype(jt))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_vjp(fn, arrays, cot, dtype, grad_types=None):
    tt = DTYPES[dtype][1]
    inputs = [torch.from_numpy(a).to(tt if grad_types is None or grad_types[i] else torch.float32)
              .requires_grad_(True) for i, a in enumerate(arrays)]
    out = fn(*inputs)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(cot).to(out.dtype))
    for g, t in zip(grads, inputs):
        assert g.dtype == t.dtype and g.shape == t.shape
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def _qkv(B, L, seed):
    rng = np.random.default_rng(seed)
    shape = (B, L, HEADS, HEAD_DIM)
    arrays = [(0.5 * rng.standard_normal(shape)).astype(np.float32) for _ in range(3)]
    return arrays, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal,L,dtype", [(False, 19, "float32"), (True, 40, "float32"),
                                            (True, 19, "bfloat16"), (False, 32, "bfloat16")])
def test_flash_attention_matches_jax(causal, L, dtype):
    """B6: the plain forward and backward against the interpret-mode kernel."""
    arrays, cot = _qkv(2, L, seed=L + causal)
    before = (tfa.flash_attention.fwd_launches, tfa.flash_attention.bwd_launches)
    out, grads = _port_vjp(lambda q, k, v: tfa.flash_attention(q, k, v, causal), arrays, cot, dtype)
    assert (tfa.flash_attention.fwd_launches, tfa.flash_attention.bwd_launches) == before  # CPU never launches
    ref_out, ref_grads = _jax_vjp(lambda q, k, v: jax_flash_attention(q, k, v, causal, True), arrays, cot, dtype)
    _assert_close(out, ref_out, dtype, "o")
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _assert_close(g, r, dtype, name)


@pytest.mark.parametrize("causal,L,dtype", [(False, 19, "float32"), (True, 32, "float32"),
                                            (True, 19, "bfloat16")])
def test_fused_qkv_attention_matches_jax(causal, L, dtype):
    """B5: ``[B, L, 3D]`` -> ``[B, L, D]`` and one ``dqkv``, against the
    interpret-mode kernel."""
    rng = np.random.default_rng(100 + L + causal)
    D = HEADS * HEAD_DIM
    qkv = (0.5 * rng.standard_normal((2, L, 3 * D))).astype(np.float32)
    cot = rng.standard_normal((2, L, D)).astype(np.float32)
    before = (tfq.fused_qkv_attention.fwd_launches, tfq.fused_qkv_attention.bwd_launches)
    out, (dqkv,) = _port_vjp(lambda t: tfq.fused_qkv_attention(t, HEADS, causal), [qkv], cot, dtype)
    assert (tfq.fused_qkv_attention.fwd_launches, tfq.fused_qkv_attention.bwd_launches) == before
    ref_out, (ref_dqkv,) = _jax_vjp(lambda t: jax_fused_qkv_attention(t, HEADS, causal, True), [qkv], cot, dtype)
    _assert_close(out, ref_out, dtype, "o")
    _assert_close(dqkv, ref_dqkv, dtype, "dqkv")


def _mlp_inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrays = [
        rng.standard_normal((B, L, D)).astype(f32),
        (1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
        (rng.standard_normal((D, 4 * D)) * (2 * D) ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(4 * D)).astype(f32),
        (rng.standard_normal((4 * D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
    ]
    return arrays, rng.standard_normal((B, L, D)).astype(np.float32)


@pytest.mark.parametrize("L,dtype", [(13, "float32"), (32, "bfloat16")])
def test_mlp_block_matches_jax(L, dtype):
    """B4: the plain forward and its backward (``_mlp_bwd``'s casts) against
    the interpret-mode kernel; only x takes the compute type, the parameters
    stay fp32 as in the model."""
    arrays, cot = _mlp_inputs(2, L, 128, seed=L)
    names = ("x", "ln_scale", "ln_bias", "fc_kernel", "fc_bias", "proj_kernel", "proj_bias")
    before = tmb.mlp_block.fwd_launches
    out, grads = _port_vjp(tmb.mlp_block, arrays, cot, dtype, grad_types=[True] + [False] * 6)
    assert tmb.mlp_block.fwd_launches == before
    jt = DTYPES[dtype][0]
    x, *params = (jnp.asarray(a) for a in arrays)
    ref, vjp = jax.vjp(lambda x, *p: jax_mlp_block(x, *p, True), x.astype(jt), *params)
    ref_grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(cot).astype(jt))]
    _assert_close(out, np.asarray(ref.astype(jnp.float32)), dtype, "out")
    for name, g, r in zip(names, grads, ref_grads):
        _assert_close(g, r, dtype, name)


def test_mlp_block_reference_saves_h_pre():
    """The forward's saved pre-activation is ``T(LN(x) @ W1 + b1)`` in the
    compute type, and the output equals the unfused MLP sub-block's in fp32."""
    arrays, _ = _mlp_inputs(2, 9, 128, seed=3)
    x, ln_s, ln_b, w1, b1, w2, b2 = (torch.from_numpy(a) for a in arrays)
    out, h_pre = tmb.mlp_block_reference(x.bfloat16(), ln_s, ln_b, w1, b1, w2, b2)
    assert h_pre.dtype == torch.bfloat16 and h_pre.shape == (2, 9, 512)
    from flyp_tpu_torch.models.layers import LayerNormFp32, MLP

    ln, mlp = LayerNormFp32(128), MLP(128)
    with torch.no_grad():
        for p, v in zip((ln.scale, ln.bias, mlp.fc_kernel, mlp.fc_bias, mlp.proj_kernel, mlp.proj_bias),
                        (ln_s, ln_b, w1, b1, w2, b2)):
            p.copy_(v)
        ref = x + mlp(ln(x))
    torch.testing.assert_close(tmb.mlp_block_reference(x, ln_s, ln_b, w1, b1, w2, b2)[0], ref,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("Lq,Lk", [(1025, 1025), (1, 9)])
def test_pallas_falls_through_to_plain_attention(Lq, Lk, monkeypatch):
    """B6 refuses L > 1024 and unequal key length before anything runs; the
    dispatch then takes plain attention, as JAX's does."""
    rng = np.random.default_rng(Lq)
    q, k, v = (rng.standard_normal((1, n, 1, 16)).astype(np.float32) for n in (Lq, Lk, Lk))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(tfa.UnsupportedShape):
        tfa.flash_attention(tq, tk, tv, False)
    assert issubclass(tfa.UnsupportedShape, NotImplementedError)
    calls = []
    monkeypatch.setattr(tfa, "flash_attention_reference", lambda *a: calls.append(a))
    out = port_attention_mod.multi_head_attention(tq, tk, tv, causal=False, impl="pallas")
    assert calls == []
    torch.testing.assert_close(out, port_attention_mod.xla_attention(tq, tk, tv, False), atol=0, rtol=0)
    if Lq < 64:  # the JAX package's own route for the short case
        ref = jax_attention_mod.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="pallas")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_pallas_dispatch_takes_b6_for_supported_shapes(monkeypatch):
    """Under ``pallas`` a self-attention shape goes through the B6 op (its
    plain version on the CPU); any other impl takes plain attention."""
    arrays, _ = _qkv(1, 9, seed=5)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    calls = []
    real = tfa._FlashAttention.apply
    monkeypatch.setattr(tfa._FlashAttention, "apply", lambda *a: calls.append(1) or real(*a))
    out = port_attention_mod.multi_head_attention(q, k, v, causal=True, impl="pallas")
    assert calls == [1]
    torch.testing.assert_close(out, tfa.flash_attention_reference(q, k, v, True), atol=0, rtol=0)
    port_attention_mod.multi_head_attention(q, k, v, causal=True, impl="pallas_block")
    assert calls == [1]


@pytest.mark.parametrize("value,expected", [(None, "pallas_block"), ("auto", "pallas_block"),
                                            ("pallas_qkv", "pallas_qkv"), ("xla", "xla")])
def test_default_impl_reads_the_environment(value, expected, monkeypatch):
    """``FLYP_ATTENTION_IMPL`` as in JAX, read once and cached; ``auto`` is
    the fused block on every device (the port's one departure)."""
    if value is None:
        monkeypatch.delenv("FLYP_ATTENTION_IMPL", raising=False)
    else:
        monkeypatch.setenv("FLYP_ATTENTION_IMPL", value)
    port_attention_mod._default_impl.cache_clear()
    try:
        assert port_attention_mod._default_impl() == expected
        monkeypatch.setenv("FLYP_ATTENTION_IMPL", "pallas")
        assert port_attention_mod._default_impl() == expected  # cached
    finally:
        port_attention_mod._default_impl.cache_clear()
