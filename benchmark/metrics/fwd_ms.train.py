"""``fwd_ms.train``: the mean device ms of the program's ``step.forward``
span (both towers and the contrastive loss) over the traced steps, timed by
the program's CUDA events on the step's stream."""

from benchmark.yardstick import spans


def read(ctx):
    if ctx.get("kind") != "train" or "trace" not in ctx:
        return None
    return spans.mean_device_ms(spans.program_spans(), "step.forward")
