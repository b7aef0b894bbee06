"""``p50_ms.latency``: the median request latency of the window, from when
a request was due to its logits on the host, in ms: a steadier statistic
beside the tail."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return ctx.get("p50_ms")
