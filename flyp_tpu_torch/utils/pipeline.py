"""Host-loop pipelining primitives.

Counterpart of ``flyp_tpu/utils/pipeline.py``: :class:`OneStepLag` keeps
one launched batch in flight while the previous one is fetched,
:func:`lagged_device_method` pairs a classifier's launch with its fetch, and
:func:`host_cast_images` / :func:`to_device` move image batches to the card
as the compute type, cast on the host (half the bytes for bf16) and copied
from pinned memory without blocking the host.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


class OneStepLag:
    """Hold one dispatched item; return the previous one on each push.

    >>> lag = OneStepLag()
    >>> for batch in loader:
    ...     handle = dispatch(batch)          # device work starts
    ...     prev = lag.push(handle)
    ...     if prev is not None:
    ...         process(prev)                 # fetch overlaps the new work
    >>> last = lag.flush()
    >>> if last is not None:
    ...     process(last)
    """

    def __init__(self) -> None:
        self._pending: Optional[Any] = None

    def push(self, item: Any) -> Optional[Any]:
        prev, self._pending = self._pending, item
        return prev

    def flush(self) -> Optional[Any]:
        prev, self._pending = self._pending, None
        return prev


def lagged_device_method(obj, device_name: str, sync_name: str):
    """``(dispatch, fetch)`` for pipelining a classifier method.

    ``dispatch(images)`` returns a handle ``(device tensor, n_valid)`` from
    the launch-only method ``device_name`` where the object has one; a
    duck-typed object with only ``sync_name`` is called synchronously and
    its handle is ``(host array, None)``.  ``fetch(handle)`` brings the
    valid rows to the host as a float32 numpy array (bf16 logits are cast
    on the card first, as numpy has no bf16)."""
    dispatch = getattr(obj, device_name, None)
    if dispatch is None:  # duck-typed object (tests, custom wrappers)
        dispatch = lambda images: (getattr(obj, sync_name)(images), None)  # noqa: E731

    def fetch(handle):
        arr, n = handle
        if n is None:
            return np.asarray(arr)
        return arr[:n].float().cpu().numpy()

    return dispatch, fetch


def host_cast_images(images, compute_dtype: torch.dtype) -> torch.Tensor:
    """A host tensor of ``images``; float images are cast to bfloat16 on the
    host when the model computes in bf16 (the towers cast on entry anyway,
    so this is exact).  Other inputs pass through."""
    t = torch.as_tensor(np.asarray(images))
    if compute_dtype == torch.bfloat16 and t.is_floating_point():
        t = t.to(torch.bfloat16)
    return t


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy a host tensor to ``device``: pinned and non-blocking to a GPU."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
