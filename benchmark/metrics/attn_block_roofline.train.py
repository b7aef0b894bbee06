"""``attn_block_roofline.train``: the roofline bound of the traced steps'
attention-block calls, B1 and B2 in both towers
(``yardstick/bounds.py``), over the device time of the program's own
kernels in those steps, in %.  The run fails where the program ran
kernels of its own that these calls do not account for."""

from benchmark.yardstick.roofline import attention_block_share


def read(ctx):
    if ctx.get("kind") != "train" or "trace" not in ctx:
        return None
    n = ctx["expected_launches"]
    return attention_block_share(ctx, {"b1": n, "b2": n})
