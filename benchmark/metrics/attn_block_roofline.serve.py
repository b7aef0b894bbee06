"""``attn_block_roofline.serve``: the roofline bound of the traced
sub-window's B3 calls at each forward's bucket rows (the work the kernel
does), over the device time of the program's own kernels there, in %.
The run fails where the program ran kernels of its own that these calls
do not account for."""

from benchmark.yardstick.roofline import attention_block_share


def read(ctx):
    if ctx.get("kind") != "serve" or "trace" not in ctx:
        return None
    return attention_block_share(ctx, {"b3": ctx["expected_launches"]})
