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
share, and each result is bit-equal to a sequential call's.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_pin_lock = threading.RLock()


@contextlib.contextmanager
def pinned_mode(model: torch.nn.Module, train: bool):
    """Run the body with every submodule of ``model`` in training mode
    (``train=True``) or eval mode, then restore each flipped submodule's own
    flag; other threads' pins wait meanwhile (module docstring)."""
    with _pin_lock:
        flipped = [m for m in model.modules() if m.training != train]
        for m in flipped:
            m.training = train
        try:
            yield model
        finally:
            for m in flipped:
                m.training = not train
