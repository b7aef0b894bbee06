"""The attention block's five bf16 products (``ops/gemm_sm90.py``, G1-G5) on
the CPU: their plain versions against the same products written with
``jax.numpy`` (bf16 operands, fp32 accumulate, the epilogue's adds, one
rounding), the CPU route, and the shapes the kernel refuses.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu_torch.ops import gemm_sm90 as gs

torch.set_num_threads(1)

F32 = jnp.float32


def _jax_product(name, ops):
    """The product in jax.numpy from the same bf16 operands."""
    a = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16 else F32) for t in ops]

    def dot(x, w):
        return jnp.matmul(x, w, preferred_element_type=F32)

    if name == "G1":
        y, w, b = a
        return jnp.stack([(dot(y, w[t]) + b[t]).astype(jnp.bfloat16) for t in range(3)])
    if name == "G2":
        o, w, b, x = a
        return ((x.astype(F32) + dot(o, w)) + b).astype(jnp.bfloat16)
    if name == "G3":
        g, w = a
        return dot(g, w.T).astype(jnp.bfloat16)
    if name == "G4":
        y, d = a
        return jnp.stack([dot(y.T, d[t]) for t in range(3)])
    d, w = a
    return sum(dot(d[t], w[t].T) for t in range(3))


@pytest.mark.parametrize("name", list(gs.PRODUCTS))
@pytest.mark.parametrize("M, D", [(70, 128), (33, 256)])
def test_plain_products_match_jax(name, M, D):
    """fp32 outputs at 1e-5 relative to the size of the sum (summation
    order); bf16 outputs within one bf16 ulp of the value plus that, as a
    flipped rounding allows."""
    op, plain, _ = gs.PRODUCTS[name]
    ops = gs.product_operands(name, M, D, "cpu", seed=M + D)
    before = op.launches
    got = op(*ops)
    assert op.launches == before  # CPU tensors never launch
    assert torch.equal(got, plain(*ops))
    ref = np.asarray(_jax_product(name, ops), np.float32)
    assert tuple(got.shape) == ref.shape
    got = got.float().numpy()
    scale = np.abs(ref).max()
    ulp = 2.0 ** -7 if name in ("G1", "G2", "G3") else 0.0
    np.testing.assert_array_less(np.abs(got - ref), ulp * np.abs(ref) + 1e-5 * scale + 1e-30)


@pytest.mark.parametrize("name", list(gs.PRODUCTS))
def test_plain_shard_products_match_jax(name):
    """A head shard of 3 heads (Dv = 192 < D = 256, the width the GEMM tiles
    64 columns at a time on the card): the plain products at the bounds of
    the whole-width test."""
    M, D, Dv = 33, 256, 192
    op, plain, _ = gs.PRODUCTS[name]
    ops = gs.product_operands(name, M, D, "cpu", seed=7, Dv=Dv)
    got = op(*ops)
    assert tuple(got.shape) == gs.product_output(name, M, D, Dv)[0]
    assert torch.equal(got, plain(*ops))
    ref = np.asarray(_jax_product(name, ops), np.float32)
    got = got.float().numpy()
    ulp = 2.0 ** -7 if name in ("G1", "G2", "G3") else 0.0
    np.testing.assert_array_less(np.abs(got - ref), ulp * np.abs(ref) + 1e-5 * np.abs(ref).max() + 1e-30)
    assert gs.product_flops(name, M, D, Dv) * D == gs.product_flops(name, M, D) * Dv


def test_products_refuse_what_the_kernel_cannot_tile():
    y = torch.zeros(8, 200, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D=200"):
        gs.qkv_product(y, torch.zeros(3, 200, 200, dtype=torch.bfloat16), torch.zeros(3, 200))
    with pytest.raises(ValueError, match="D=64"):
        gs.grad_out_product(torch.zeros(8, 64, dtype=torch.bfloat16), torch.zeros(64, 64, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        gs.weight_grad_product(torch.zeros(8, 128), torch.zeros(3, 8, 128))
    with pytest.raises(ValueError, match="shape"):
        gs.out_product(*gs.product_operands("G2", 8, 128, "cpu")[:3], torch.zeros(9, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="Dv=96"):  # not a whole number of 64-wide heads
        gs.grad_out_product(torch.zeros(8, 128, dtype=torch.bfloat16), torch.zeros(96, 128, dtype=torch.bfloat16))


def test_bounds_count_each_byte_once():
    """G1 at the vision shape: 178.5 GFLOP; y and the weights read once, q,
    k and v written once."""
    M, D = 256 * 197, 768
    assert gs.product_flops("G1", M, D) == 2 * M * D * 3 * D
    assert gs.product_bytes("G1", M, D) == 2 * M * D + 2 * 3 * D * D + 4 * 3 * D + 2 * 3 * M * D
    assert gs.product_flops("G2", M, D) * 3 == gs.product_flops("G5", M, D)
