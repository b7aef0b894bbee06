"""``stream_attn_roofline.train`` and ``yardstick/attn_bounds.py`` on the
CPU: the attention step's operations and bytes against counts worked out
by hand, and the reader on synthetic span logs and traces: the share it
reads, and the runs it fails (a stray streamed kernel, spans that do not
match the launch counters)."""

import pytest

from benchmark import harness
from benchmark.yardstick import attn_bounds, spans
from benchmark.yardstick.peaks import PEAKS

SXM = PEAKS["sxm"]
FWD = "void flyp::attention_fwd_stream_kernel<true, true, 80>(flyp::AttnArgs)"
BWD_Q = "void flyp::attention_bwd_q_stream_kernel<true, 80>(flyp::AttnArgs)"
BWD_K = "void flyp::attention_bwd_k_stream_kernel<true, 80>(flyp::AttnArgs)"
REG = "void flyp::attention_fwd_kernel<true, true, 2>(flyp::AttnArgs)"
GEMM = "void flyp::sm90::gemm_sm90_kernel<256, false, true, 2>(flyp::sm90::Params)"


def test_forward_counts_by_hand():
    # 4 x 4 x 257^2 x 1280 products; q, k, v, o: 4 x 4 x 257 x 1280 bf16; lse
    # 4 x 257 x 16 fp32 in training only.
    assert attn_bounds.forward(4, 257, 1280, 16, False, train=True) == (1_352_683_520, 10_526_720 + 65_792)
    assert attn_bounds.forward(4, 257, 1280, 16, False, train=False) == (1_352_683_520, 10_526_720)
    assert attn_bounds.forward(4, 257, 1280, 16, True, train=False) == (676_341_760, 10_526_720)


def test_backward_counts_by_hand():
    # Five L x L products: 10 x 4 x 257^2 x 1280; q, k, v, do read and dq,
    # dk, dv written: 7 x 4 x 257 x 1280 bf16; lse read.
    assert attn_bounds.backward(4, 257, 1280, 16, False) == (3_381_708_800, 18_421_760 + 65_792)
    assert attn_bounds.backward(4, 257, 1280, 16, True) == (1_690_854_400, 18_421_760 + 65_792)


def test_vit_h14_step_is_bound_by_bytes():
    """At ViT-H/14's batch 256 and 257 keys the attention step is bound by
    its bytes: 0.202 ms forward, 0.353 ms backward."""
    fwd = attn_bounds.seconds(*attn_bounds.forward(256, 257, 1280, 16, False, True), SXM)
    bwd = attn_bounds.seconds(*attn_bounds.backward(256, 257, 1280, 16, False), SXM)
    assert fwd == pytest.approx((4 * 256 * 257 * 1280 * 2 + 256 * 257 * 16 * 4) / 3.35e12)
    assert bwd == pytest.approx((7 * 256 * 257 * 1280 * 2 + 256 * 257 * 16 * 4) / 3.35e12)
    assert 1e3 * fwd == pytest.approx(0.2024, abs=1e-4) and 1e3 * bwd == pytest.approx(0.3532, abs=1e-4)


def _span(name, route="stream", B=4, L=257, D=1280, heads=16, causal=False):
    return {"name": name, "id": None, "parent": None, "root": 1, "thread": 1, "start_ns": 0, "end_ns": 1,
            "attrs": {"B": B, "L": L, "D": D, "heads": heads, "head_dim": D // heads, "causal": causal,
                      "route": route}}


def _ctx(kernels, b1=2, b2=2, b3=0):
    return {"kind": "train", "peaks": SXM, "trace": {"kernels": kernels},
            "counters": {"b1": b1, "b2": b2, "b3": b3, "b4": 0, "b5": 0, "b6": 0}}


@pytest.fixture
def log(monkeypatch):
    held = {"spans": None}
    monkeypatch.setattr(spans, "program_spans", lambda: held["spans"])
    return held


# Two steps of one streamed block (B1, B2) and one text block on the register
# route, with the GEMMs' kernels beside them.
STEPS = [_span("attn.block_fwd"), _span("attn.block_fwd", "register", L=32, D=128, heads=2, causal=True),
         _span("attn.block_bwd"), _span("attn.block_bwd", "register", L=32, D=128, heads=2, causal=True)]
KERNELS = [(FWD, 0.0002), (REG, 0.00001), (GEMM, 0.0005), (BWD_Q, 0.0003), (BWD_K, 0.0004)]


def test_reader_takes_the_streamed_calls_over_their_kernels(log):
    log["spans"] = STEPS * 2
    got = harness.read_metric("stream_attn_roofline.train", _ctx(KERNELS * 2, b1=4, b2=4))
    bound = 2 * (attn_bounds.seconds(*attn_bounds.forward(4, 257, 1280, 16, False, True), SXM)
                 + attn_bounds.seconds(*attn_bounds.backward(4, 257, 1280, 16, False), SXM))
    assert got == pytest.approx(100 * bound / (2 * 0.0009))


def test_reader_reads_nothing_where_there_is_nothing(log):
    log["spans"] = None  # a program without the spans
    assert harness.read_metric("stream_attn_roofline.train", _ctx(KERNELS)) is None
    log["spans"] = []
    assert harness.read_metric("stream_attn_roofline.train", _ctx(KERNELS)) is None
    log["spans"] = [s for s in STEPS if s["attrs"]["route"] == "register"]  # no long rows: ViT-B/16
    assert harness.read_metric("stream_attn_roofline.train", _ctx([(REG, 1e-5), (GEMM, 1e-3)], b1=1, b2=1)) is None
    log["spans"] = STEPS
    assert harness.read_metric("stream_attn_roofline.train", {"kind": "train"}) is None  # untraced
    assert harness.read_metric("stream_attn_roofline.train", dict(_ctx(KERNELS), kind="serve")) is None


def test_reader_fails_on_a_stray_streamed_kernel(log):
    """A streamed launch that no span accounts for (here one forward
    kernel more) fails the run: the bound would not cover it."""
    log["spans"] = STEPS
    with pytest.raises(RuntimeError, match="streamed kernels ran"):
        harness.read_metric("stream_attn_roofline.train", _ctx(KERNELS + [(FWD, 0.0002)]))
    log["spans"] = [s for s in STEPS if s["attrs"]["route"] == "register"]
    with pytest.raises(RuntimeError, match="streamed kernels ran"):
        harness.read_metric("stream_attn_roofline.train", _ctx(KERNELS, b1=1, b2=1))


def test_reader_fails_where_spans_and_counters_differ(log):
    log["spans"] = STEPS
    with pytest.raises(RuntimeError, match="launch counters"):
        harness.read_metric("stream_attn_roofline.train", _ctx(KERNELS, b1=3))
    with pytest.raises(RuntimeError, match="launch counters"):
        harness.read_metric("stream_attn_roofline.train", _ctx(KERNELS, b3=1))
