"""The few-shot command line: independent restarts of the k-shot protocol,
their mean and standard deviation to ``stats_final.txt``.

Counterpart of ``flyp_tpu/cli/few_shot.py``, with the trainer's flags
(``cli/main.py::parse_main_arguments``, ``--device`` included)::

    python -m flyp_tpu_torch.cli.few_shot --model ViT-B/16 --k 16 \\
        --ft_data train_shot_16.tsv --template patchcamelyon_template \\
        --train-dataset PatchCamelyonTrain \\
        --eval-datasets PatchCamelyonVal,PatchCamelyonTest \\
        --data-location ~/data --epochs 20 --lr 1e-5 --save checkpoints

Models go under ``<save>/<exp_name>/<run key>`` and the log and
``stats_final.txt`` under ``expt_logs/<exp_name>/<run key>``.  The protocol
runs in one process: under torchrun with more than one rank it raises.
"""

from __future__ import annotations

import os

from flyp_tpu_torch.cli.main import init_distributed, parse_main_arguments
from flyp_tpu_torch.training.few_shot import few_shot_driver
from flyp_tpu_torch.utils.logging import get_logger


def main(cfg=None, num_runs: int = 50):
    cfg = cfg or parse_main_arguments()
    if cfg.save is None:
        raise AssertionError("Please provide a path to store models")
    joined = init_distributed(cfg)
    try:
        run_key = cfg.run_key()
        exp = cfg.exp_name or "few_shot"
        cfg.save = os.path.join(cfg.save, exp, run_key)
        os.makedirs(cfg.save, exist_ok=True)
        cfg.log_dir = os.path.join("expt_logs", exp, run_key)
        os.makedirs(cfg.log_dir, exist_ok=True)
        logger = get_logger(cfg.log_dir)
        logger.info(cfg)
        return few_shot_driver(cfg, logger, num_runs=num_runs)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
