"""``mfu.serve``: the FLOPs of the image forward and the head's product
over the images users sent (not the padded rows), a second over the
window, against the card's bf16 peak, in %."""

from benchmark.yardstick.shares import mfu


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return mfu(ctx)
