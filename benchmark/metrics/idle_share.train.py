"""``idle_share.train``: the share of the traced steps in which no kernel,
copy or set ran on the card, in %."""

from benchmark.yardstick.shares import idle_share


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return idle_share(ctx)
