"""``mfu.train``: the model FLOPs of the window's train steps (products,
forward and backward, no recompute; ``yardstick/flops.py``) a second,
over the bf16 peak of the card, in %; the host's clock over the untraced
window."""

from benchmark.yardstick.shares import mfu


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return mfu(ctx)
