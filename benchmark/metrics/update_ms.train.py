"""``update_ms.train``: the mean device ms of the program's ``step.update``
span (``AdamW.update`` over every parameter and both moments) over the
traced steps."""

from benchmark.yardstick import spans


def read(ctx):
    if ctx.get("kind") != "train" or "trace" not in ctx:
        return None
    return spans.mean_device_ms(spans.program_spans(), "step.update")
