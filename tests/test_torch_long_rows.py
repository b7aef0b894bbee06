"""The port's plain attention versions at long rows against the JAX package.

On the card the streamed route (bf16 rows above 256 keys,
``flyp_tpu_torch/csrc/attention.cuh``) is held to the plain PyTorch versions
beside the kernels.  This file holds those plain versions to the JAX
package's kernels at L = 257 (ViT-L/14's vision length), where one key sits
alone in the last 64-key tile, causal or not, at a tiny width (batch 1, two
heads of 64).  Same numpy-seeded inputs through the JAX ops in interpret mode
(their CPU route to the TPU kernels) and through the port's ops, whose CPU
route is the plain version: B3 (``attention_block_inference``), B1 + B2
(``attention_block`` and its grads, the saved lse), B5
(``fused_qkv_attention``) and B6 (``flash_attention``), on random inputs and
on inputs whose last key carries most of each row's weight
(``testing.edge_key_qkv``, ``testing.edge_key_block_inputs``).

Bounds, as at short rows (test_torch_attention_block*.py,
test_torch_attention_impls.py): fp32 outputs 2e-5 (B1-B3) or 1e-5 (B5/B6)
absolute plus relative, the attention block's grads 5e-4 (the JAX package's
own bound for its kernel against XLA), B5/B6's 1e-5; only fp32 summation
orders differ.  bf16 (B6): each element within 5e-2 absolute plus relative
and a mean error under 2e-3 (a flipped bf16 rounding of p, o or ds
propagates).  The edge-key outputs are ~3 in size, so their absolute terms
scale by that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.ops.attention_block import _fwd_call
from flyp_tpu.ops.attention_block import attention_block as jax_attention_block
from flyp_tpu.ops.attention_block import attention_block_inference as jax_attention_block_inference
from flyp_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flyp_tpu.ops.fused_qkv_attention import fused_qkv_attention as jax_fused_qkv_attention
from flyp_tpu_torch import testing
from flyp_tpu_torch.ops import attention_block as tab
from flyp_tpu_torch.ops import flash_attention as tfa
from flyp_tpu_torch.ops import fused_qkv_attention as tfq

torch.set_num_threads(1)

L, HEADS, D = 257, 2, 128
BLOCK_NAMES = ("x", "ln_scale", "ln_bias", "qkv_kernel", "qkv_bias", "out_kernel", "out_bias")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _block_inputs(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrays = (
        rng.standard_normal((1, L, D)).astype(f32),
        (1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
        (rng.standard_normal((3, D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal((3, D))).astype(f32),
        (rng.standard_normal((D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
    )
    return arrays, rng.standard_normal((1, L, D)).astype(f32)


def _jax_vjp(fn, arrays, cot, dtype="float32", n_cast=None):
    """Output and grads of ``fn`` through ``jax.vjp``; the first ``n_cast``
    arrays (all by default) in ``dtype``, the rest (the block's parameters)
    in fp32."""
    jt = DTYPES[dtype][0]
    n_cast = len(arrays) if n_cast is None else n_cast
    out, vjp = jax.vjp(fn, *(jnp.asarray(a).astype(jt) if i < n_cast else jnp.asarray(a)
                             for i, a in enumerate(arrays)))
    grads = vjp(jnp.asarray(cot).astype(out.dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_vjp(fn, arrays, cot, dtype="float32", n_cast=None):
    """The same through ``torch.autograd.grad``."""
    tt = DTYPES[dtype][1]
    n_cast = len(arrays) if n_cast is None else n_cast
    inputs = [torch.from_numpy(a).to(tt if i < n_cast else torch.float32).requires_grad_(True)
              for i, a in enumerate(arrays)]
    out = fn(*inputs)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(cot).to(out.dtype))
    for g, t in zip(grads, inputs):
        assert g.dtype == t.dtype and g.shape == t.shape
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def _assert_close(got, ref, dtype, name, atol):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=atol, rtol=atol, err_msg=name)
        return
    assert np.abs(got - ref).mean() <= 2e-3, (name, np.abs(got - ref).mean())
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2, err_msg=name)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_inference_block_matches_jax_at_long_rows(causal, edge):
    """B3's plain version against the interpret-mode kernel, fp32 at 2e-5
    (the edge-key outputs, ~3 in size, at 2e-5 relative to that)."""
    arrays = testing.edge_key_block_inputs(1, L, D, seed=3)[0] if edge else _block_inputs(seed=1 + causal)[0]
    x, *params = (torch.from_numpy(a) for a in arrays)
    before = tab.attention_block_inference.launches
    with torch.inference_mode():
        out = tab.attention_block_inference(x, *params, HEADS, causal).numpy()
    assert tab.attention_block_inference.launches == before  # CPU tensors never launch
    ref = np.asarray(jax_attention_block_inference(*(jnp.asarray(a) for a in arrays), HEADS, causal, True))
    np.testing.assert_allclose(out, ref, atol=2e-5 * (3.0 if edge else 1.0), rtol=2e-5)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_training_block_matches_jax_at_long_rows(causal, edge):
    """B1 + B2's plain versions (the training op's output and every grad)
    against ``jax.vjp`` of the interpret-mode kernels, fp32: output 2e-5,
    grads 5e-4."""
    arrays, cot = testing.edge_key_block_inputs(1, L, D, seed=4) if edge else _block_inputs(seed=5 + causal)
    before = (tab.attention_block.fwd_launches, tab.attention_block.bwd_launches)
    out, grads = _port_vjp(lambda x, *p: tab.attention_block(x, *p, HEADS, causal), arrays, cot, n_cast=1)
    assert (tab.attention_block.fwd_launches, tab.attention_block.bwd_launches) == before
    ref_out, ref_grads = _jax_vjp(lambda x, *p: jax_attention_block(x, *p, HEADS, causal, True), arrays, cot,
                                  n_cast=1)
    np.testing.assert_allclose(out, ref_out, atol=2e-5 * (3.0 if edge else 1.0), rtol=2e-5)
    for name, g, r in zip(BLOCK_NAMES, grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=5e-4, rtol=5e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_saved_residuals_match_jax_at_long_rows(causal):
    """B1's plain (out, o, q, k, v, lse), the residuals B2 reads, against
    the JAX kernel's, fp32 at 2e-5."""
    arrays, _ = _block_inputs(seed=7 + causal)
    jx = _fwd_call(*(jnp.asarray(a) for a in arrays), HEADS, causal, True)
    port = tab.attention_block_reference(*(torch.from_numpy(a) for a in arrays), HEADS, causal)
    for name, p, r in zip(("out", "o", "q", "k", "v", "lse"), port, jx):
        assert tuple(p.shape) == tuple(r.shape), name
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=2e-5, rtol=2e-5, err_msg=name)


def _random_qkv(seed):
    rng = np.random.default_rng(seed)
    shape = (1, L, HEADS, 64)
    arrays = [(0.5 * rng.standard_normal(shape)).astype(np.float32) for _ in range(3)]
    return arrays, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_at_long_rows(causal, dtype, edge):
    """B6's plain forward and backward against the interpret-mode kernel:
    fp32 1e-5 (3e-5 on the edge-key inputs, whose o is ~3), bf16 5e-2 per
    element and 2e-3 mean."""
    if edge:
        *arrays, cot = testing.edge_key_qkv(1, L, HEADS, seed=11)
    else:
        arrays, cot = _random_qkv(seed=13 + causal)
    before = (tfa.flash_attention.fwd_launches, tfa.flash_attention.bwd_launches)
    out, grads = _port_vjp(lambda q, k, v: tfa.flash_attention(q, k, v, causal), arrays, cot, dtype)
    assert (tfa.flash_attention.fwd_launches, tfa.flash_attention.bwd_launches) == before
    ref_out, ref_grads = _jax_vjp(lambda q, k, v: jax_flash_attention(q, k, v, causal, True), arrays, cot, dtype)
    atol = 3e-5 if edge else 1e-5
    _assert_close(out, ref_out, dtype, "o", atol)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _assert_close(g, r, dtype, name, atol)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_qkv_attention_matches_jax_at_long_rows(causal):
    """B5's plain ``[B, L, 3D]`` forward and ``dqkv`` against the
    interpret-mode kernel, fp32 at 1e-5."""
    rng = np.random.default_rng(17 + causal)
    qkv = (0.5 * rng.standard_normal((1, L, 3 * D))).astype(np.float32)
    cot = rng.standard_normal((1, L, D)).astype(np.float32)
    out, (dqkv,) = _port_vjp(lambda t: tfq.fused_qkv_attention(t, HEADS, causal), [qkv], cot)
    ref_out, (ref_dqkv,) = _jax_vjp(lambda t: jax_fused_qkv_attention(t, HEADS, causal, True), [qkv], cot)
    np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dqkv, ref_dqkv, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", [257, 321, 577])
def test_check_catches_a_dropped_last_tile(length, causal):
    """On the edge-key inputs (the last key alone in its 64-key tile, with
    most of each row's weight), a softmax whose sum drops the last tile
    (``testing.forward_without_last_tile``) fails ``check_attention`` in bf16
    by far more than its bounds.  On random inputs without the mask the same
    fault moves every row's p by only ~0.4%, which the bound on the share of
    unequal elements catches."""
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16) for a in testing.edge_key_qkv(1, length, HEADS, seed=19))
    ref = tfa.flash_attention_reference(q, k, v, causal)
    faulty = testing.forward_without_last_tile(q, k, v, causal)
    with pytest.raises(AssertionError, match="disagrees"):
        testing.check_attention("planted fault", faulty, ref)
    assert testing.attention_errors(faulty, ref)["max_abs"] > 10 * testing.ATTENTION_TOL[torch.bfloat16][1]
    p = tfa._probs(q, k, causal)[..., -1]
    seen = p[:, :, -1:] if causal else p
    assert float(seen.min()) > 0.95  # the last key carries most of every row's weight that sees it
    if not causal:
        arrays, _ = _random_qkv(seed=length)
        qr, kr, vr = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
        with pytest.raises(AssertionError, match="disagrees"):
            testing.check_attention("planted fault", testing.forward_without_last_tile(qr, kr, vr),
                                    tfa.flash_attention_reference(qr, kr, vr))
