"""The bounds that hold the B5/B6 kernels to their plain versions
(``flyp_tpu_torch.testing.check_attention``) pass what differs only in fp32
summation order and fail a planted fault.

The stand-in for the kernel is the plain version itself with the keys in
another order: every sum over keys then runs in another order, as the
kernel's do, and bf16 roundings may flip.  The planted faults are the
plain backward with ``delta = rowsum(p dp)`` dropped from ``ds``, the
plain forward with ``p`` cast before it is normalised, and the plain
backward with ``delta = rowsum(do T(o))``.
"""

import numpy as np
import pytest
import torch

from flyp_tpu_torch.ops import flash_attention as tfa
from flyp_tpu_torch.testing import (
    ATTENTION_TOL,
    attention_errors,
    backward_delta_from_o,
    backward_without_delta,
    check_attention,
    forward_cast_before_normalising,
)

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


def _passes_the_first_three_bounds(got, ref):
    rel, atol, ulp, mean, _ = ATTENTION_TOL[ref.dtype]
    errs = attention_errors(got, ref)
    over = int(((got.float() - ref.float()).abs() > atol + ulp * ref.float().abs()).sum())
    return not over and errs["rel_norm"] <= rel and errs["mean_abs"] <= mean


@pytest.mark.parametrize("causal", [False, True])
def test_check_catches_p_cast_before_normalising(causal):
    """At L=197 in bf16, o with p cast before its normalisation moves by an
    ulp or so, within the norm, elementwise and mean bounds, but in about
    half of its elements: the unequal-share bound catches it."""
    q, k, v, _ = _inputs(torch.bfloat16, L=197, seed=5)
    ref = tfa.flash_attention_reference(q, k, v, causal)
    faulty = forward_cast_before_normalising(q, k, v, causal)
    assert _passes_the_first_three_bounds(faulty, ref)
    share = attention_errors(faulty, ref)["unequal_share"]
    assert share > 20 * ATTENTION_TOL[torch.bfloat16][4], share
    with pytest.raises(AssertionError, match="disagrees"):
        check_attention("o", faulty, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_check_catches_delta_from_rounded_o(causal):
    """At L=197 in bf16, delta = rowsum(do T(o)) moves dq and dk within the
    first three bounds but in about a quarter of their elements: the
    unequal-share bound catches both; dv, which delta does not enter,
    passes."""
    q, k, v, do = _inputs(torch.bfloat16, L=197, seed=6)
    ref = tfa.flash_attention_backward_reference(q, k, v, do, causal)
    faulty = backward_delta_from_o(q, k, v, do, causal)
    for name, got, want in zip(("dq", "dk"), faulty, ref):
        assert _passes_the_first_three_bounds(got, want), name
        share = attention_errors(got, want)["unequal_share"]
        assert share > 10 * ATTENTION_TOL[torch.bfloat16][4], (name, share)
        with pytest.raises(AssertionError, match="disagrees"):
            check_attention(name, got, want)
    check_attention("dv", faulty[2], ref[2])


def test_faults_are_no_faults_in_float32():
    """In fp32 the casts round nothing, so both faults equal the op to fp32
    summation order and pass: the bound holds bf16's rounding points."""
    q, k, v, do = _inputs(torch.float32, L=50, seed=7)
    check_attention("o", forward_cast_before_normalising(q, k, v), tfa.flash_attention_reference(q, k, v))
    ref = tfa.flash_attention_backward_reference(q, k, v, do)
    for name, got, want in zip(("dq", "dk", "dv"), backward_delta_from_o(q, k, v, do), ref):
        check_attention(name, got, want)


def test_check_refuses_non_finite_values():
    q, k, v, _ = _inputs(torch.float32, L=8, seed=4)
    o = tfa.flash_attention_reference(q, k, v)
    bad = o.clone()
    bad[0, 0, 0, 0] = float("nan")
    with pytest.raises(AssertionError):
        check_attention("o", bad, o)
