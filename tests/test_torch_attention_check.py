"""The bounds that hold the B5/B6 kernels to their plain versions
(``flyp_tpu_torch.testing.check_attention``) pass what differs only in fp32
summation order and fail a planted fault.

The stand-in for the kernel is the plain version itself with the keys in
another order: every sum over keys then runs in another order, as the
kernel's do, and bf16 roundings may flip.  The planted fault is the plain
backward with ``delta = rowsum(p dp)`` dropped from ``ds``.
"""

import numpy as np
import pytest
import torch

from flyp_tpu_torch.ops import flash_attention as tfa
from flyp_tpu_torch.testing import ATTENTION_TOL, backward_without_delta, check_attention

torch.set_num_threads(1)


def _inputs(dtype, L=40, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, L, 2, 64)).astype(np.float32)).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_passes_another_summation_order(dtype):
    q, k, v, do = _inputs(dtype, seed=1)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(q.shape[1]))
    inv = torch.argsort(perm)
    o = tfa.flash_attention_reference(q, k, v)
    o_perm = tfa.flash_attention_reference(q, k[:, perm], v[:, perm])
    check_attention("o", o_perm, o)
    ref = tfa.flash_attention_backward_reference(q, k, v, do)
    dq, dk, dv = tfa.flash_attention_backward_reference(q, k[:, perm], v[:, perm], do)
    for name, got, want in (("dq", dq, ref[0]), ("dk", dk[:, inv], ref[1]), ("dv", dv[:, inv], ref[2])):
        check_attention(name, got, want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_catches_a_dropped_delta(dtype, causal):
    """dq and dk without delta fail (by the relative norm alone, at many
    times its bound); dv, which delta does not enter, passes."""
    q, k, v, do = _inputs(dtype, seed=3)
    ref = tfa.flash_attention_backward_reference(q, k, v, do, causal)
    faulty = backward_without_delta(q, k, v, do, causal)
    rel_bound = ATTENTION_TOL[dtype][0]
    for name, got, want in zip(("dq", "dk"), faulty, ref):
        with pytest.raises(AssertionError, match="disagrees"):
            check_attention(name, got, want)
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel > 5 * rel_bound, (name, rel)
    check_attention("dv", faulty[2], ref[2])


def test_check_refuses_non_finite_values():
    q, k, v, _ = _inputs(torch.float32, L=8, seed=4)
    o = tfa.flash_attention_reference(q, k, v)
    bad = o.clone()
    bad[0, 0, 0, 0] = float("nan")
    with pytest.raises(AssertionError):
        check_attention("o", bad, o)
