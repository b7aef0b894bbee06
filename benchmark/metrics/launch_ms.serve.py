"""``launch_ms.serve``: over the traced burst's forwards, the median host
ms of the program's ``serve.forward`` span: one chunk's launch under the
mode lock."""

from benchmark.yardstick import spans


def read(ctx):
    if ctx.get("kind") != "serve" or "trace" not in ctx:
        return None
    return spans.median_host_ms(spans.program_spans(), "serve.forward")
