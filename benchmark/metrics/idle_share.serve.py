"""``idle_share.serve``: the share of the traced burst of requests (a full
queue) in which no kernel, copy or set ran on the card: the host's cost,
in %."""

from benchmark.yardstick.shares import idle_share


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return idle_share(ctx)
