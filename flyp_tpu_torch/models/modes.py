"""Pinning a model's mode where the JAX package pins ``train``.

The JAX package passes ``train`` to the model explicitly: ``False`` (the
default of ``CLIPModel.encode_image`` / ``encode_text``) where the
zero-shot head is built, in the classifier and in the server, ``True`` in
the train step.
The port's modules read the module's ``training`` flag instead
(``ResidualBlock.attention``; ``TorchBatchNorm``, batch or running
statistics), so those four callers pin it for their call and give the
caller's mode back afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def pinned_mode(model: torch.nn.Module, train: bool):
    """Run the body with every submodule of ``model`` in training mode
    (``train=True``) or eval mode, then restore each flipped submodule's own
    flag."""
    flipped = [m for m in model.modules() if m.training != train]
    for m in flipped:
        m.training = train
    try:
        yield model
    finally:
        for m in flipped:
            m.training = not train
