"""The port's training attention-block op against the JAX package's kernels.

Same inputs (numpy, seeded) through ``flyp_tpu.ops.attention_block.
attention_block`` in interpret mode (the JAX package's CPU route to the TPU
kernels ``_fwd_kernel`` and ``_bwd_kernel``) and ``flyp_tpu_torch.ops.
attention_block.attention_block``, whose CPU route is the plain PyTorch
version of the forward (B1) and the backward (B2).  Grads come from
``jax.vjp`` and ``torch.autograd.grad`` with the same numpy cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.ops.attention_block import _fwd_call
from flyp_tpu.ops.attention_block import attention_block as jax_attention_block
from flyp_tpu.ops.attention_block import attention_block_inference as jax_attention_block_inference
from flyp_tpu_torch.ops import attention_block as tab

torch.set_num_threads(1)

NAMES = ("x", "ln_scale", "ln_bias", "qkv_kernel", "qkv_bias", "out_kernel", "out_bias")
HEADS = 2


def _inputs(B, L, D, seed):
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
    cot = rng.standard_normal((B, L, D)).astype(f32)
    return arrays, cot


def _jax_vjp(fn, arrays, cot, causal, dtype=jnp.float32):
    x, *params = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(lambda x, *p: fn(x, *p, HEADS, causal, True), x.astype(dtype), *params)
    grads = vjp(jnp.asarray(cot).astype(dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grad(fn, arrays, cot, causal, dtype=torch.float32):
    x, *params = (torch.from_numpy(a) for a in arrays)
    inputs = [x.to(dtype).requires_grad_(True)] + [p.requires_grad_(True) for p in params]
    out = fn(*inputs, HEADS, causal)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(cot).to(dtype))
    for g, t in zip(grads, inputs):
        assert g.dtype == t.dtype and g.shape == t.shape
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [13, 16])
def test_training_op_matches_jax_kernels_fp32(causal, L):
    """fp32: outputs at 2e-5 and grads at 5e-4 (the JAX package's own bound
    for its kernel against XLA); only fp32 summation orders differ."""
    arrays, cot = _inputs(3, L, 128, seed=L + 2 * causal)
    before = (tab.attention_block.fwd_launches, tab.attention_block.bwd_launches)
    out, grads = _port_grad(tab.attention_block, arrays, cot, causal)
    assert (tab.attention_block.fwd_launches, tab.attention_block.bwd_launches) == before  # CPU never launches
    ref_out, ref_grads = _jax_vjp(jax_attention_block, arrays, cot, causal)
    np.testing.assert_allclose(out, ref_out, atol=2e-5, rtol=2e-5)
    for name, g, r in zip(NAMES, grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=5e-4, rtol=5e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_saved_residuals_match_jax_fwd_call(causal):
    """The plain training forward's (out, o, q, k, v, lse) against the JAX
    kernel's outputs, fp32 at 2e-5 (lse is relative to the scaled scores)."""
    arrays, _ = _inputs(2, 13, 128, seed=21 + causal)
    jx = _fwd_call(*(jnp.asarray(a) for a in arrays), HEADS, causal, True)
    port = tab.attention_block_reference(*(torch.from_numpy(a) for a in arrays), HEADS, causal)
    for name, p, r in zip(("out", "o", "q", "k", "v", "lse"), port, jx):
        assert tuple(p.shape) == tuple(r.shape), name
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=2e-5, rtol=2e-5, err_msg=name)


def test_training_op_matches_jax_kernels_bf16():
    """bf16: both sides round at the same points, but fp32 sums in another
    order can flip a bf16 rounding (2**-8 relative) of q/k/v, e, o, do, ds
    or dq/dk/dv, and the flip propagates.  Bounds: the output at 3e-2
    absolute + relative per element and a mean error under 2e-3; each grad
    at 5e-2 of its largest magnitude per element and a mean error under 1e-2
    of it (the weight grads sum 48 rows of such values)."""
    arrays, cot = _inputs(3, 16, 128, seed=5)
    out, grads = _port_grad(tab.attention_block, arrays, cot, True, torch.bfloat16)
    ref_out, ref_grads = _jax_vjp(jax_attention_block, arrays, cot, True, jnp.bfloat16)
    np.testing.assert_allclose(out, ref_out, atol=3e-2, rtol=3e-2)
    assert np.abs(out - ref_out).mean() < 2e-3
    for name, g, r in zip(NAMES, grads, ref_grads):
        size = np.abs(r).max()
        err = np.abs(g - r)
        assert err.max() < 5e-2 * size, (name, err.max(), size)
        assert err.mean() < 1e-2 * size, (name, err.mean(), size)


@pytest.mark.parametrize("causal", [False, True])
def test_inference_op_grads_match_training_op_and_jax(causal):
    """The inference op's backward re-runs the training forward and backward:
    its grads equal the training op's exactly and JAX's grads of
    ``attention_block_inference`` at 5e-4."""
    arrays, cot = _inputs(2, 13, 128, seed=31 + causal)
    out_i, grads_i = _port_grad(tab.attention_block_inference, arrays, cot, causal)
    out_t, grads_t = _port_grad(tab.attention_block, arrays, cot, causal)
    np.testing.assert_allclose(out_i, out_t, atol=2e-5, rtol=2e-5)
    for name, a, b in zip(NAMES, grads_i, grads_t):
        np.testing.assert_array_equal(a, b, err_msg=name)
    _, ref_grads = _jax_vjp(jax_attention_block_inference, arrays, cot, causal)
    for name, g, r in zip(NAMES, grads_i, ref_grads):
        np.testing.assert_allclose(g, r, atol=5e-4, rtol=5e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_reference_matches_autograd_through_plain_forward(causal):
    """In fp32 the explicit backward equals autograd through the plain
    forward up to summation order (5e-5): the rounding casts are identities
    and the -1e30 mask has zero gradient."""
    arrays, cot = _inputs(2, 13, 128, seed=41 + causal)
    x, *params = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    out, o, q, k, v, lse = tab.attention_block_reference(x, *params, HEADS, causal)
    g = torch.from_numpy(cot)
    auto = torch.autograd.grad(out, [x, *params], g)
    with torch.no_grad():
        explicit = tab.attention_block_backward_reference(
            g, x, params[0], params[1], params[2], params[4], o, q, k, v, lse, HEADS, causal)
    order = (0, 1, 2, 3, 4, 5, 6)  # dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout
    for i, name in zip(order, NAMES):
        torch.testing.assert_close(explicit[i], auto[i], atol=5e-5, rtol=5e-5, msg=name)
