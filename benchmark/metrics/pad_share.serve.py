"""``pad_share.serve``: the padded rows over the rows the forwards computed
in the window, in %, counted from the requests' sizes and the server's
buckets and chunks."""

from benchmark.yardstick.shares import pad_share


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return pad_share(ctx)
