"""The arithmetic the per-layer readers share (``benchmark/metrics/``):
each reader picks its cells' readings and calls one of these.  Each
returns None where the run read nothing for it."""

from __future__ import annotations


def mfu(ctx) -> float | None:
    """Model FLOPs of the untraced window a second over the card's bf16
    peak, in %."""
    timed, peaks = ctx.get("timed"), ctx.get("peaks")
    if not timed or not peaks:
        return None
    return 100.0 * timed["flops"] / timed["seconds"] / peaks["bf16"]


def idle_share(ctx) -> float | None:
    """The traced sub-window's share without a kernel, copy or set on the
    card, in %."""
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def peak_gib(ctx) -> float | None:
    """The allocator's most over the window on the fullest card, in GiB."""
    return ctx["peak_bytes"] / 2 ** 30 if ctx.get("peak_bytes") else None


def pad_share(ctx) -> float | None:
    """Padded rows over the rows the forwards computed, in %."""
    rows = ctx.get("rows")
    if not rows or not rows["computed"]:
        return None
    return 100.0 * (rows["computed"] - rows["sent"]) / rows["computed"]

