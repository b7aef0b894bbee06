"""The FLYP trainer's zero-shot head.

Counterpart of the head-building half of ``flyp_tpu/training/flyp.py``:
the class names for the per-epoch zero-shot head, and the head itself.
The trainer loop (``flyp_train``) is ROADMAP.md item A6.
"""

from __future__ import annotations

from typing import List

from flyp_tpu_torch.data.registry import get_classnames_for
from flyp_tpu_torch.evaluation.zeroshot import get_zeroshot_classifier
from flyp_tpu_torch.templates import get_template


def _resolve_zeroshot_classnames(cfg) -> List[str]:
    """Class names of the zero-shot head: iWildCam's ``english`` names as
    written under ``--self_data``, else those of ``cfg.train_dataset``."""
    if cfg.self_data:
        from flyp_tpu_torch.data.datasets.wilds_sets import iwildcam_english_names

        return iwildcam_english_names()
    return get_classnames_for(cfg.train_dataset, cfg)


def build_zeroshot_head(cfg, model):
    template = get_template(cfg.template)
    classnames = _resolve_zeroshot_classnames(cfg)
    return get_zeroshot_classifier(model, classnames, template)
