"""Pinning a model's mode where the JAX package pins ``train``.

The JAX package passes ``train`` to the model explicitly: ``False`` (the
default of ``CLIPModel.encode_image`` / ``encode_text``) where the
zero-shot head is built, in the classifier and in the server, ``True`` in
the train step.
The port's modules read the module's ``training`` flag instead
(``ResidualBlock.attention``; ``TorchBatchNorm``, batch or running
statistics), so those four callers pin it for their call and give the
caller's mode back afterwards.

The flags are shared state of the module tree, and ``ClipServer`` answers
requests on concurrent threads (``serving/http.py``).  So a pin holds one
process-wide reentrant lock for its body: a second thread's pin waits until
the first has restored the flags, and nested pins of one thread (a tower
pinned inside its model, as the Fisher and the CE ablation do) take it
again.  One lock, not one per module, because pins of a model and of its
tower flip overlapping trees.  Concurrent requests then run their forwards
one after another, as their kernels would on the one CUDA stream they
share, and each result is bit-equal to a sequential call's.  Under a
profiler a pin given ``wait_span`` times its wait for the lock as a span
of that name (``utils/profiling.py::span``), unless the thread holds it
already.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from flyp_tpu_torch.utils.profiling import span, spans_on

_pin_lock = threading.RLock()


@contextlib.contextmanager
def pinned_mode(model: torch.nn.Module, train: bool, wait_span: Optional[str] = None):
    """Run the body with every submodule of ``model`` in training mode
    (``train=True``) or eval mode, then restore each flipped submodule's own
    flag; other threads' pins wait meanwhile, their wait a span named
    ``wait_span`` if given (module docstring)."""
    if wait_span is not None and spans_on() and not _pin_lock._is_owned():
        with span(wait_span):
            _pin_lock.acquire()
    else:
        _pin_lock.acquire()
    try:
        flipped = [m for m in model.modules() if m.training != train]
        for m in flipped:
            m.training = train
        try:
            yield model
        finally:
            for m in flipped:
                m.training = not train
    finally:
        _pin_lock.release()
