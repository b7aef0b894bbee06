"""``peak_gib.train``: the most device memory the allocator held over the
window (``torch.cuda.max_memory_allocated`` after a reset at its start),
in GiB."""

from benchmark.yardstick.shares import peak_gib


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return peak_gib(ctx)
