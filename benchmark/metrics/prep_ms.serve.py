"""``prep_ms.serve``: over the traced burst's requests, the median of the
host ms each spent in the program's ``serve.cast``, ``serve.pad`` and
``serve.h2d`` spans together: the host cast, the bucket padding, and the
pin and copy issue of its chunks."""

from benchmark.yardstick import spans


def read(ctx):
    if ctx.get("kind") != "serve" or "trace" not in ctx:
        return None
    return spans.median_request_ms(spans.program_spans(), ("serve.cast", "serve.pad", "serve.h2d"))
