"""Classifier = CLIP image tower + classification head.

Counterpart of ``flyp_tpu/evaluation/classifier.py``: a batch pads to one
fixed ``batch_size`` (the shape every evaluation batch shares), the image
features optionally renormalise, and the head gives the logits.  The image
tower runs in eval mode whatever the model's mode (the JAX package's
``train=False``; every block takes the inference kernel, B3), and the
model's mode is restored afterwards.  ``*_device`` calls launch the work and return device tensors
without a host fetch, so an evaluation loop can launch batch i+1 before it
fetches batch i.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.head import ClassificationHead
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.utils.pipeline import host_cast_images, to_device


class Classifier:
    def __init__(self, model: CLIPModel, head: ClassificationHead, batch_size: int = 128,
                 normalize_features: bool = False):
        self.model = model
        self.head = head
        self.batch_size = batch_size
        self.normalize_features = normalize_features

    def replace_head(self, head: ClassificationHead) -> "Classifier":
        return Classifier(self.model, head, self.batch_size, self.normalize_features)

    def _pad(self, images) -> Tuple[torch.Tensor, int]:
        # Cast before padding, so the ragged tail copies half the bytes.
        images = host_cast_images(images, self.model.compute_dtype)
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(
                f"batch of {n} images exceeds this Classifier's batch_size={self.batch_size}; split the "
                "request (or use flyp_tpu_torch.serving.ClipServer, which buckets and chunks)"
            )
        if n != self.batch_size:
            pad = torch.zeros((self.batch_size - n, *images.shape[1:]), dtype=images.dtype)
            images = torch.cat([images, pad])
        return to_device(images, self.model.device), n

    @torch.inference_mode()
    def features_device(self, images) -> Tuple[torch.Tensor, int]:
        """(device features [batch_size, D], n_valid), no host fetch."""
        padded, n = self._pad(images)
        with pinned_mode(self.model, train=False):
            return self.model.encode_image(padded), n

    @torch.inference_mode()
    def predict_logits_device(self, images) -> Tuple[torch.Tensor, int]:
        """(device logits [batch_size, num_classes], n_valid), no host fetch."""
        feats, n = self.features_device(images)
        if self.normalize_features:
            # Renormalised before the head (the reference's
            # ImageClassifier_Norm); the head may normalise again.
            feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return self.head(feats), n

    def predict_logits(self, images) -> np.ndarray:
        """[n <= batch_size, H, W, C] host images -> [n, num_classes] fp32 logits."""
        out, n = self.predict_logits_device(images)
        return out[:n].float().cpu().numpy()

    def features(self, images) -> np.ndarray:
        out, n = self.features_device(images)
        return out[:n].float().cpu().numpy()
