"""Contrastive (InfoNCE) loss, plus the three supervised variants of CLIP's
reference loss.

Counterpart of ``flyp_tpu/ops/losses.py::clip_loss``.  Without ``group``
the logit matrix spans the batch it is given.  With ``group`` (the process
group of the mesh's batch axes, the JAX package's ``axis_name``) each rank
passes its own rows and the features are all-gathered with a
differentiable gather (``parallel/comm.py::gather_rows``, whose backward
reduce-scatters the gradient), so the logits span the global batch.

The default variant returns per-item losses (the curriculum machinery
consumes them); the supervised variants return a scalar, as upstream does.
"""

from __future__ import annotations

from typing import Optional

import torch


def _log_softmax_diag_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy with integer labels: logsumexp(row) - row[label]."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[:, None])[:, 0]
    return lse - picked


def _soft_ce(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    return -torch.sum(target_probs * torch.log_softmax(logits, dim=-1), dim=-1)


def clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    ground_labels: Optional[torch.Tensor] = None,
    *,
    ignore: bool = False,
    google_sup_loss: bool = False,
    group=None,
    local_loss: bool = False,
) -> torch.Tensor:
    """Bidirectional contrastive loss over L2-normalised features.

    Args:
      image_features / text_features: ``[B, D]`` (already normalised).
      logit_scale: scalar temperature, already exponentiated.
      ground_labels: optional ``[B]`` integer class labels enabling the
        supervised variants.
      ignore: drop same-class negatives from the denominator.
      google_sup_loss: supervised contrastive, each positive scored against a
        denominator that excludes its own term.
      With labels and neither flag: soft-label cross entropy over the
      normalised label-equality matrix.
      group: the batch axes' process group; the features (and labels) are
        gathered over it in group-rank order.
      local_loss: with ``group``, only this rank's rows ``[B_local,
        B_global]`` of the logits, labelled ``arange(B_local) + B_local *
        rank``.  The supervised variants ignore it: they need the whole
        label-equality matrix and return the same scalar on every rank.

    Returns:
      ``[B]`` (``[B_global]`` with ``group``, ``[B_local]`` with
      ``local_loss``) per-item losses for the default variant; a scalar for
      the supervised variants.  Everything is computed in fp32.

    A training step over a group backpropagates each rank's share of the
    global-batch mean (its own rows' per-item losses over ``B_global``, or
    a supervised scalar over the group size) and sums the gradients over
    the group: the gather's backward then gives every rank the gradient of
    the global mean for its features, and ``logit_scale``'s gradient sums to
    the global one.
    """
    if ignore and google_sup_loss:
        raise ValueError("please specify only one of ignore and google_sup_loss")
    img = image_features.float()
    txt = text_features.float()
    scale = logit_scale.float()
    local_b = img.shape[0]
    rank = 0
    # Supervised variants ignore local_loss: rectangular logits would
    # mis-index the label-equality matrix.
    local_loss = local_loss and ground_labels is None
    if group is not None:
        from flyp_tpu_torch.parallel.comm import gather_rows, group_rank

        rank = group_rank(group)
        all_img, all_txt = gather_rows(img, group), gather_rows(txt, group)
        if local_loss:
            logits_per_image = scale * img @ all_txt.T  # [B_local, B_global]
            logits_per_text = scale * txt @ all_img.T
        else:
            logits_per_image = scale * all_img @ all_txt.T  # [B_global, B_global]
            logits_per_text = logits_per_image.T
        if ground_labels is not None:
            from flyp_tpu_torch.parallel.comm import all_gather

            ground_labels = all_gather(ground_labels, group)
    else:
        logits_per_image = scale * img @ txt.T
        logits_per_text = logits_per_image.T
    n = logits_per_image.shape[0]

    if ground_labels is not None:
        equal = (ground_labels[None, :] == ground_labels[:, None]).float()

        if ignore:
            keep = 1.0 - (equal - torch.eye(n, dtype=torch.float32, device=equal.device))

            def masked_infonce(logits):
                z = torch.exp(logits - logits.amax(dim=1, keepdim=True)) * keep
                return -torch.log(torch.diagonal(z) / z.sum(dim=1))

            return (masked_infonce(logits_per_image).mean() + masked_infonce(logits_per_text).mean()) / 2.0

        if google_sup_loss:

            def sup(logits):
                z = torch.exp(logits - logits.amax(dim=1, keepdim=True))
                denom = z.sum(dim=1, keepdim=True) - z
                per_pair = -torch.log(z / denom) * equal
                return (per_pair.sum(dim=1) / equal.sum(dim=1)).mean()

            return (sup(logits_per_image) + sup(logits_per_text)) / 2.0

        soft = equal / equal.sum(dim=1, keepdim=True)
        return (_soft_ce(logits_per_image, soft).mean() + _soft_ce(logits_per_text, soft).mean()) / 2.0

    if group is not None and local_loss:
        labels = torch.arange(local_b, device=logits_per_image.device) + local_b * rank
    else:
        labels = torch.arange(n, device=logits_per_image.device)
    return (_log_softmax_diag_ce(logits_per_image, labels) + _log_softmax_diag_ce(logits_per_text, labels)) / 2.0
