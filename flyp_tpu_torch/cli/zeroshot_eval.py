"""Zero-shot evaluation: build the prompt-template head from a CLIP model
and run the evaluation suites, with no training.

Counterpart of ``flyp_tpu/cli/zeroshot_eval.py``; it takes the trainer's
flags (``flyp_tpu_torch.config``) and runs on ``cfg.device`` (the card
unless a caller asks for the CPU)::

    python -m flyp_tpu_torch.cli.zeroshot_eval --clip_load model.pt \\
        --model ViT-B/16 --train-dataset ImageNet \\
        --template openai_imagenet_template \\
        --eval-datasets ImageNet,ImageNetR,ObjectNet \\
        --data-location ~/data --batch-size 256 --workers 6

``--save DIR`` also writes the head to ``DIR/zeroshot_head``
(``utils/checkpoint.py::save_params``; ``restore_params`` reads it).
"""

from __future__ import annotations

import os

from flyp_tpu_torch.config import parse_arguments
from flyp_tpu_torch.evaluation.classifier import Classifier
from flyp_tpu_torch.evaluation.evaluator import evaluate
from flyp_tpu_torch.models.factory import build_clip_model
from flyp_tpu_torch.training.flyp import build_zeroshot_head
from flyp_tpu_torch.utils.checkpoint import save_params
from flyp_tpu_torch.utils.logging import get_logger


def main(cfg=None):
    cfg = cfg or parse_arguments()
    cfg.log_dir = cfg.log_dir or os.path.join("expt_logs", cfg.exp_name or "zeroshot", cfg.run_key())
    logger = get_logger(cfg.log_dir)

    model = build_clip_model(cfg, device=cfg.device)
    head = build_zeroshot_head(cfg, model)
    classifier = Classifier(model, head, batch_size=cfg.batch_size)

    train_stats: dict = {}
    evaluate(classifier, cfg, train_stats, logger)
    for key, value in train_stats.items():
        logger.info(f"{key}: {value}")

    if cfg.save is not None:
        path = save_params(os.path.join(cfg.save, "zeroshot_head"), {"weight": head.weight, "bias": head.bias})
        logger.info(f"Saved zero-shot head to {path}")
    return train_stats


if __name__ == "__main__":
    main()
