"""``lock_wait_ms.serve``: over the traced burst's forwards, the median host
ms of the program's ``serve.lock_wait`` span: a request thread's wait for
``models/modes.py::pinned_mode``'s lock before its launch."""

from benchmark.yardstick import spans


def read(ctx):
    if ctx.get("kind") != "serve" or "trace" not in ctx:
        return None
    return spans.median_host_ms(spans.program_spans(), "serve.lock_wait")
