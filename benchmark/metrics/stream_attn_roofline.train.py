"""``stream_attn_roofline.train``: the roofline bound of the attention step
of the traced steps' attention-block calls on the streamed route (the
program's ``attn.block_*`` spans whose ``route`` is ``"stream"``;
``yardstick/attn_bounds.py``), over the device time of the streamed
kernels ``flyp::attention_{fwd,bwd_q,bwd_k}_stream_kernel`` in the trace,
in %.  ``attn_block_roofline.train``'s share at the attention kernels
alone, at the cell's head width.

The run fails where the spans' counts differ from the launch counters of
B1, B2 and B3, or where the trace holds launches of the streamed kernels
that no span accounts for (one forward kernel a forward span, one of each
backward kernel a backward span).  A program without these spans reads
nothing."""

from benchmark.yardstick import attn_bounds, spans
from benchmark.yardstick.kernels import trace_name

KERNELS = {"flyp::attention_fwd_stream_kernel": "forward", "flyp::attention_bwd_q_stream_kernel": "backward",
           "flyp::attention_bwd_k_stream_kernel": "backward"}


def read(ctx):
    if ctx.get("kind") != "train" or "trace" not in ctx or not ctx.get("peaks"):
        return None
    calls = [s for s in spans.program_spans() or () if s["name"] in attn_bounds.SPANS]
    if not calls:
        return None
    counted = {c: 0 for c, _ in attn_bounds.SPANS.values()}
    for s in calls:
        counted[attn_bounds.SPANS[s["name"]][0]] += 1
    counters = {c: ctx["counters"].get(c, 0) for c in counted}
    if counted != counters:
        raise RuntimeError(f"the attention-block spans count {counted}, the launch counters {counters}")
    streamed = [s for s in calls if s["attrs"]["route"] == "stream"]
    want = {"forward": 0, "backward": 0}
    for s in streamed:
        want[attn_bounds.SPANS[s["name"]][1]] += 1
    launches = {name: 0 for name in KERNELS}
    kernel_s = 0.0
    for name, dur in ctx["trace"]["kernels"]:
        short = trace_name(name)
        if short in KERNELS:
            launches[short] += 1
            kernel_s += dur
    expected = {name: want[kind] for name, kind in KERNELS.items()}
    if launches != expected:
        raise RuntimeError(f"streamed kernels ran {launches}; the streamed spans account for {expected}")
    if not streamed or kernel_s <= 0:
        return None
    return 100.0 * sum(attn_bounds.span_seconds(s, ctx["peaks"]) for s in streamed) / kernel_s
