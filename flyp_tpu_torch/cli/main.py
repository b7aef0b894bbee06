"""The FLYP trainer's command line.

Counterpart of ``flyp_tpu/cli/main.py``, with its flags
(``flyp_tpu_torch.config``) and one more, ``--device`` (``cuda``, the
default, or ``cpu``)::

    python -m flyp_tpu_torch.cli.main --model ViT-B/16 --ft_data train.tsv \\
        --train-dataset ImageNet --template openai_imagenet_template \\
        --eval-datasets ImageNet,ImageNetR --data-location ~/data \\
        --batch-size 256 --epochs 10 --data_backend native --workers 6 \\
        --save checkpoints --exp_name flyp

Across ranks it runs under ``torchrun`` (one process a card; the mesh
comes from ``--mesh_data``, ``--mesh_model``, ``--mesh_replica`` and
``--fsdp``)::

    torchrun --nproc_per_node 2 -m flyp_tpu_torch.cli.main ... --mesh_model 2

Under torchrun (``WORLD_SIZE`` in the environment) each process joins the process
group (``nccl`` under ``--device cuda``, on card ``LOCAL_RANK``; ``gloo``
under ``--device cpu``) and leaves it on exit.

Run directories are keyed ``<exp_name>/_BS{bs}_WD{wd}_LR{lr}_run{n}`` under
``--save`` (checkpoints) and ``expt_logs/`` (log, stats TSVs, metrics).
Dispatch, as in the JAX CLI: ``--ce_ablation`` runs the cross-entropy
ablation (``training/ce_ablation.py``, on a mesh too),
``--progress_validation`` the progress-validation beam search
(``training/progress.py``, one process), anything else the FLYP trainer.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from flyp_tpu_torch.config import ExperimentConfig, parse_arguments
from flyp_tpu_torch.utils.logging import get_logger


def parse_main_arguments(argv: Optional[List[str]] = None) -> ExperimentConfig:
    """The trainer's flags plus ``--device``."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ns, rest = pre.parse_known_args(argv)
    cfg = parse_arguments(rest)
    cfg.device = ns.device
    return cfg


def init_distributed(cfg) -> bool:
    """Join the process group when launched by torchrun (``WORLD_SIZE`` in
    the environment, one process included): ``nccl`` with ``cfg.device`` set to
    ``cuda:LOCAL_RANK``, or ``gloo`` for ``--device cpu``.  A rank that
    finds no card under ``--device cuda`` raises.  Returns whether it
    joined."""
    import torch.distributed as dist

    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    cpu = torch.device(cfg.device).type == "cpu"
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {os.environ.get('RANK')} (LOCAL_RANK {local}) finds no CUDA device under "
                               "--device cuda; pass --device cpu to train on the CPU")
        torch.cuda.set_device(local)
        cfg.device = f"cuda:{local}"
    if cpu:
        dist.init_process_group("gloo")
    else:
        dist.init_process_group("nccl", device_id=torch.device(cfg.device))
    return True


def main(cfg=None):
    cfg = cfg or parse_main_arguments()
    joined = init_distributed(cfg)
    try:
        return _main(cfg)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(cfg):
    run_key = cfg.run_key()
    exp = cfg.exp_name or "flyp"
    if cfg.save is not None:
        cfg.save = os.path.join(cfg.save, exp, run_key)
        os.makedirs(cfg.save, exist_ok=True)
    cfg.log_dir = os.path.join("expt_logs", exp, run_key)
    os.makedirs(cfg.log_dir, exist_ok=True)
    logger = get_logger(cfg.log_dir)
    logger.info(cfg)

    if cfg.ce_ablation:
        from flyp_tpu_torch.training.ce_ablation import ce_ablation

        return ce_ablation(cfg, logger)
    if cfg.progress_validation:
        from flyp_tpu_torch.training.progress import flyp_progress_validation

        return flyp_progress_validation(cfg, logger)

    from flyp_tpu_torch.training.flyp import flyp_train

    return flyp_train(cfg, logger)


if __name__ == "__main__":
    main()
