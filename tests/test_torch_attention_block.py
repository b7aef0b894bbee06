"""The port's attention-block op against the JAX package's inference kernel.

Same inputs (numpy, seeded) through ``flyp_tpu.ops.attention_block.
attention_block_inference`` in interpret mode (the JAX package's own CPU
route) and ``flyp_tpu_torch.ops.attention_block.attention_block_inference``,
whose CPU route is the plain PyTorch version.  The training op is in
``test_torch_attention_block_train.py``; the kernels against the plain
versions on the card are in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.ops.attention import xla_attention
from flyp_tpu.ops.attention_block import attention_block_inference as jax_attention_block_inference
from flyp_tpu_torch.ops import attention_block as tab
from flyp_tpu_torch.ops.attention import plain_attention

torch.set_num_threads(1)

_NAMES = ("x", "ln_scale", "ln_bias", "qkv_kernel", "qkv_bias", "out_kernel", "out_bias")


def _inputs(B, L, D, seed=0):
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


def _jax(arrays, heads, causal, dtype=jnp.float32):
    x, *params = (jnp.asarray(a) for a in arrays)
    out = jax_attention_block_inference(x.astype(dtype), *params, heads, causal, True)
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, heads, causal, dtype=torch.float32, device="cpu"):
    x, *params = (torch.from_numpy(a).to(device) for a in arrays)
    with torch.inference_mode():
        return tab.attention_block_inference(x.to(dtype), *params, heads, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [13, 16])
def test_plain_block_matches_jax_kernel_fp32(causal, L):
    """fp32 at 2e-5: only the summation order of D- and L-long fp32 dot
    products differs between the two."""
    arrays = _inputs(3, L, 128, seed=L + causal)
    before = tab.attention_block_inference.launches
    out = _port(arrays, 2, causal)
    assert tab.attention_block_inference.launches == before  # CPU tensors never launch
    np.testing.assert_allclose(out.numpy(), _jax(arrays, 2, causal), atol=2e-5, rtol=2e-5)


def test_plain_block_matches_jax_kernel_bf16():
    """bf16: both round at the same points, but fp32 sums in another order
    can flip a bf16 rounding (2**-8 relative) inside q/k/v, p or o, and the
    flip propagates.  Bound: 3e-2 absolute + relative per element (a few
    bf16 ulps of the O(1) outputs) and a mean error under 2e-3."""
    arrays = _inputs(2, 16, 128, seed=7)
    ref = _jax(arrays, 2, True, jnp.bfloat16)
    out = _port(arrays, 2, True, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, atol=3e-2, rtol=3e-2)
    assert np.abs(out - ref).mean() < 2e-3


def test_cpu_route_is_the_plain_version():
    arrays = _inputs(2, 13, 128, seed=3)
    before = tab.attention_block_inference.launches
    out = _port(arrays, 2, True)
    ref = tab.attention_block_inference_reference(*(torch.from_numpy(a) for a in arrays), 2, True)
    assert torch.equal(out, ref)
    assert tab.attention_block_inference.launches == before


def test_forward_only():
    """With no input requiring grad the inference op is forward-only: no
    autograd graph, and the same values as under inference_mode."""
    x, *params = (torch.from_numpy(a) for a in _inputs(1, 5, 128))
    out = tab.attention_block_inference(x, *params, 2, False)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, _port(_inputs(1, 5, 128), 2, False))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_jax_xla_attention(causal):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 13, 2, 64)).astype(np.float32) for _ in range(3))
    ref = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    out = plain_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_block_reference_matches_unfused_composition(causal):
    """The fused op equals LN -> QKV -> plain attention -> out-proj ->
    residual composed from plain ops (fp32: the scale moves from the
    scores to q and the mask from -inf to -1e30, both exact up to
    rounding of the scaled scores)."""
    x, g, b, wqkv, bqkv, wout, bout = (torch.from_numpy(a) for a in _inputs(2, 13, 128, seed=5))
    B, L, D = x.shape
    y = torch.nn.functional.layer_norm(x, (D,), g, b, eps=1e-5)
    q, k, v = ((y @ wqkv[t] + bqkv[t]).reshape(B, L, 2, 64) for t in range(3))
    ref = x + plain_attention(q, k, v, causal).reshape(B, L, D) @ wout + bout
    out = tab.attention_block_inference_reference(x, g, b, wqkv, bqkv, wout, bout, 2, causal)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)

