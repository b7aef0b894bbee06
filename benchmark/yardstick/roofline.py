"""What the attention-block rooflines share: the program's kernel time in a
traced sub-window, and the check that the calls the bound counts are all
the port's kernels that ran there."""

from benchmark.yardstick.kernels import trace_name


def attention_block_share(ctx, launches: dict):
    """100 x the bound of the sub-window's attention-block calls over the
    device time of every kernel of the program's libraries there.  Raises
    where the program ran other kernels of its own, or other counts, than
    the calls that ``launches`` ({counter: count}) expects: the bound would
    not cover them."""
    trace = ctx.get("trace")
    if not trace or not ctx.get("peaks"):
        return None
    counts = ctx["counters"]
    wrong = {k: v for k, v in counts.items() if v != launches.get(k, 0)}
    if wrong:
        raise RuntimeError(f"the program's launch counters read {counts}, the bound counts {launches}")
    port = {name for names in ctx["port_kernels"].values() for name in names}
    allowed = {name for src in ctx["allowed_sources"] for name in ctx["port_kernels"][src]}
    seen = {trace_name(n) for n, _ in trace["kernels"]} & port
    if seen - allowed:
        raise RuntimeError(f"program kernels outside the bounded calls ran: {sorted(seen - allowed)}")
    port_s = sum(s for n, s in trace["kernels"] if trace_name(n) in port)
    if port_s <= 0:
        return None
    return 100.0 * ctx["bound_s"] / port_s
