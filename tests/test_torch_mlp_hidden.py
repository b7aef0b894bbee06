"""The bound that holds B4's hidden activations ``h`` to the GELU of the
kernel's own ``h_pre`` (``flyp_tpu_torch.testing.check_mlp_hidden``).

On the card, the bf16 MLP block writes ``h = T(quick_gelu(fp32(h_pre)))``
from the rounded ``h_pre`` into device memory for its second product, the
rounding of the JAX kernel (``flyp_tpu/ops/mlp_block.py::_fwd_kernel``,
which rounds ``hpre`` before ``_quick_gelu`` upcasts it).  Here: the port's
``h`` of the plain forward's ``h_pre`` equals JAX's ``_quick_gelu`` of the
same ``h_pre``, passes the bound, and the planted fault (``h`` of the fp32
sum before it is rounded) fails it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.ops.mlp_block import _quick_gelu as jax_quick_gelu
from flyp_tpu_torch.ops import mlp_block as tmb
from flyp_tpu_torch.testing import check_mlp_hidden, mlp_hidden_from_unrounded

torch.set_num_threads(1)


def _inputs(dtype, B=2, L=9, D=128, seed=0):
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
    x, *params = (torch.from_numpy(a) for a in arrays)
    return [x.to(dtype), *params]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_hidden_is_jax_gelu_and_passes(dtype):
    args = _inputs(dtype, seed=1)
    _, h_pre = tmb.mlp_block_reference(*args)
    h = tmb.mlp_hidden(h_pre)
    jt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jax_quick_gelu(jnp.asarray(h_pre.float().numpy()).astype(jt)).astype(jnp.float32))
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(h.float().numpy(), ref)
    else:  # the two fp32 sigmoids differ in their last bit now and then
        np.testing.assert_allclose(h.numpy(), ref, rtol=2.0 ** -22, atol=1e-30)
    errs = check_mlp_hidden(h, h_pre, "plain")
    assert errs["unequal_share"] == 0.0 and errs["max_ulps"] == 0.0


def test_check_catches_hidden_of_the_unrounded_sum():
    """The GELU of the fp32 ``y W1 + b1`` (not of the rounded ``h_pre``)
    stays within an ulp but moves far more than 0.1% of the bf16 outputs."""
    args = _inputs(torch.bfloat16, seed=2)
    _, h_pre = tmb.mlp_block_reference(*args)
    faulty = mlp_hidden_from_unrounded(*args[:5])
    unequal = float((faulty != tmb.mlp_hidden(h_pre)).float().mean())
    assert unequal > 0.01, unequal
    with pytest.raises(AssertionError, match="not the GELU"):
        check_mlp_hidden(faulty, h_pre, "planted fault")


def test_check_catches_an_unwritten_element():
    args = _inputs(torch.bfloat16, seed=3)
    _, h_pre = tmb.mlp_block_reference(*args)
    h = tmb.mlp_hidden(h_pre)
    h.view(-1)[5] = float("nan")
    with pytest.raises(AssertionError, match="not the GELU"):
        check_mlp_hidden(h, h_pre)
