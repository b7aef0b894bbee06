"""The head-shard forms of B1-B3 on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor ``flyp_tpu``:

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py -m cuda -q

Tolerances are ``chip_smoke.py``'s: fp32 1e-4 and bf16 2e-2 on outputs,
B2's dx 5e-2 in bf16, and the relative norm of the sums over rows (dWqkv,
dbqkv, dscale, dbias, dWout, dbout) 1e-5 in fp32 and 1e-2 in bf16.
"""

import pytest
import torch

from flyp_tpu_torch.ops import attention_block as tab

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DX_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, L, D, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=g)).cuda()

    return (r(B, L, D).to(dtype), r(D, scale=0.1, shift=1.0), r(D, scale=0.1), r(3, D, D, scale=D ** -0.5),
            r(3, D, scale=0.1), r(D, D, scale=D ** -0.5), r(D, scale=0.1)), r(B, L, D).to(dtype)


def _shard(args, n, i):
    x, s, b, wqkv, bqkv, wout, bout = args
    dv = wqkv.shape[-1] // n
    cols = slice(i * dv, (i + 1) * dv)
    return x, s, b, wqkv[:, :, cols].contiguous(), bqkv[:, cols].contiguous(), wout[cols].contiguous(), bout


def _close(got, want, tol):
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol + tol * want.float().abs()).all()), float(err.max())


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_kernels_match_plain_and_sum_to_the_whole(card, dtype, causal, n):
    """Two shards of 6 heads (Dv = 384 of D = 768), or four of 3 (Dv = 192,
    the GEMMs' 64-column tiles): B3 and B1 in ``partial`` mode and B2 with
    ``add_g=False`` against their plain versions, and their sums (plus x +
    bout, or g) against the unsharded kernels.  Each shard's dWout is its
    heads' rows of the whole one, and its dbout the whole one, bit for
    bit."""
    B, L, D, H = 4, 197, 768, 12
    args, g = _inputs(B, L, D, dtype, seed=3 + causal)
    x, s, b, wqkv, _, wout, bout = args
    with torch.no_grad():
        whole3 = tab._fwd_kernel_call(*args, H, causal, train=False)
        whole1 = tab._fwd_kernel_call(*args, H, causal, train=True)
        whole2 = tab._bwd_kernel_call(g, x, s, b, wqkv, wout, *whole1[1:], H, causal)
        p3, p1, p2 = [], [], []
        for i in range(n):
            sa = _shard(args, n, i)
            p3.append(tab._fwd_kernel_call(*sa, H // n, causal, train=False, partial=True))
            _close(p3[-1], tab.attention_block_inference_reference(*sa, H // n, causal, partial=True), TOL[dtype])
            p1.append(tab._fwd_kernel_call(*sa, H // n, causal, train=True, partial=True))
            ref1 = tab.attention_block_reference(*sa, H // n, causal, partial=True)
            for got, want in zip(p1[-1][:5], ref1[:5]):
                _close(got, want, TOL[dtype])
            p2.append(tab._bwd_kernel_call(g, x, s, b, sa[3], sa[5], *p1[-1][1:], H // n, causal, add_g=False))
            ref2 = tab.attention_block_backward_reference(g, x, s, b, sa[3], sa[5], *p1[-1][1:], H // n, causal,
                                                          add_g=False)
            _close(p2[-1][0], ref2[0], DX_TOL[dtype])
            assert len(p2[-1]) == len(ref2) == 7
            assert max(_rel(a, r) for a, r in zip(p2[-1][1:], ref2[1:])) <= NORM_TOL[dtype]
            dv = D // n
            assert p2[-1][5].shape == (dv, D)
            assert _rel(p2[-1][5], whole2[5][i * dv:(i + 1) * dv]) <= NORM_TOL[dtype]
            assert torch.equal(p2[-1][6], whole2[6])
        _close(((x.float() + sum(p3)) + bout.float()).to(dtype), whole3, TOL[dtype])
        _close(((x.float() + sum(r[0] for r in p1)) + bout.float()).to(dtype), whole1[0], TOL[dtype])
        _close((g.float() + sum(r[0].float() for r in p2)).to(dtype), whole2[0], DX_TOL[dtype])
        assert _rel(torch.cat([r[3] for r in p2], dim=-1), whole2[3]) <= NORM_TOL[dtype]
        assert _rel(sum(r[1] for r in p2), whole2[1]) <= NORM_TOL[dtype]


def test_tp_block_of_one_rank_matches_the_fused_block(card):
    """``tp_attention_block`` over no group (one rank holding every head)
    runs the partial kernels and adds x + bout itself: its output and the
    seven grads equal the fused block's within the bf16 rule."""
    args, g = _inputs(4, 77, 512, torch.bfloat16, seed=9)
    ins = [t.detach().clone().requires_grad_(True) for t in args]
    ref_ins = [t.detach().clone().requires_grad_(True) for t in args]
    out = tab.tp_attention_block(*ins, 8, True, group=None, train=True)
    ref = tab.attention_block(*ref_ins, 8, True)
    _close(out, ref, TOL[torch.bfloat16])
    grads = torch.autograd.grad(out, ins, g)
    ref_grads = torch.autograd.grad(ref, ref_ins, g)
    _close(grads[0], ref_grads[0], DX_TOL[torch.bfloat16])
    for a, r in zip(grads[1:], ref_grads[1:]):
        assert _rel(a, r) <= NORM_TOL[torch.bfloat16]
