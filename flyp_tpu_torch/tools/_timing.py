"""Timing and seeded data for the probes.

:func:`time_call` is the counterpart of the JAX tools' ``_time``/``_sync``:
one warm-up call ending in a host fetch of one element, then ``iters`` calls
between two CUDA events (the host clock on the CPU), the loop again ending in
a host fetch of one element, as the JAX tools' loops end.  The data comes
from ``np.random.default_rng(seed)`` as in the JAX tools, drawn in float32
(or int8) on the host and cast on the device.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _first(out) -> torch.Tensor:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def fetch(out) -> float:
    """One element of the first tensor in ``out``, on the host."""
    return float(_first(out).reshape(-1)[0].float().item())


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn, *args, iters: int) -> float:
    """Seconds per call of ``fn(*args)``."""
    out = fn(*args)
    fetch(out)
    if _first(out).device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        fetch(out)
        return (time.perf_counter() - t0) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn(*args)
    end.record()
    fetch(out)
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def normal(rng: np.random.Generator, shape, dtype, device) -> torch.Tensor:
    """Standard normal values of ``dtype`` on ``device``."""
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device).to(dtype)


def integers(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """int8 values in [-127, 127), as the JAX tools draw them."""
    return torch.from_numpy(rng.integers(-127, 127, shape, dtype=np.int8)).to(device)
