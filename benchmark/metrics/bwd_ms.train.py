"""``bwd_ms.train``: the mean device ms of the program's ``step.backward``
span (``torch.autograd.grad`` to every trained parameter, remat's
recompute included) over the traced steps."""

from benchmark.yardstick import spans


def read(ctx):
    if ctx.get("kind") != "train" or "trace" not in ctx:
        return None
    return spans.mean_device_ms(spans.program_spans(), "step.backward")
