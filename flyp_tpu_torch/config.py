"""Experiment configuration: one dataclass, CLI-flag parity with the JAX
package (``flyp_tpu/config.py``: the same flags, destinations, choices and
defaults), so a command line of the JAX trainer parses to the same config.

Two fields differ by design: ``device`` is ``"cuda"`` (the JAX package
stores ``jax.default_backend()``; the port's entry points run on the card
unless a caller asks for the CPU), and ``data_backend`` still accepts
``tfdata`` and ``grain``, which ``training/data.py::train_loader`` refuses
by name.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass
class ExperimentConfig:
    # core
    data_location: str = os.path.expanduser("~/data")
    eval_datasets: Optional[List[str]] = None
    train_dataset: Optional[str] = None
    template: Optional[str] = None
    classnames: str = "openai"
    alpha: List[float] = dataclasses.field(default_factory=lambda: [0.5])
    exp_name: Optional[str] = None
    results_db: Optional[str] = None
    model: Optional[str] = None
    batch_size: int = 128
    lr: float = 0.001
    wd: float = 0.1
    ls: float = 0.0
    warmup_length: int = 500
    num_classes: int = 1000
    epochs: int = 10
    load: Optional[object] = None  # str or list of str
    save: Optional[str] = None
    freeze_encoder: bool = False
    cache_dir: Optional[str] = None
    # fisher
    fisher: Optional[List[str]] = None
    fisher_floor: float = 1e-8
    # data
    ft_data: Optional[str] = None
    ft_data_test: Optional[str] = None
    dataset_type: str = "auto"
    train_num_samples: Optional[int] = None
    csv_separator: str = "\t"
    csv_img_key: str = "filepath"
    csv_caption_key: str = "title"
    get_labeled_csv: bool = False
    # research / curriculum
    ce_ablation: bool = False
    curriculum: bool = False
    baseline: bool = False
    cont_finetune: bool = False
    progress_eval: bool = False
    progress_train: bool = False
    progress: bool = False
    progress_validation: bool = False
    progress_metric: str = "Acc"
    cluster: str = ""
    ma_progress: bool = False
    explore: bool = False
    debug: bool = False
    proportion: bool = False
    test: bool = False
    scheduler: str = "default"
    datalimit: int = -1
    curriculum_epoch: Optional[int] = None
    self_data: bool = False
    guidance: int = -1
    # misc
    k: Optional[int] = None
    seed: int = 0
    workers: int = 6
    clip_load: Optional[str] = None
    wise_save: Optional[str] = None
    run: int = 1
    min_lr: float = 0.0
    wandb_group_name: str = "default"
    slurm_job_id: int = -1
    # cont_finetune class filter (the reference hardcodes the stats path and
    # thresholds; here they are flags)
    class_stats_path: Optional[str] = None
    cont_filter_key: str = "IWildCamOOD"
    cont_acc_threshold: float = 0.5
    cont_count_threshold: int = 50
    # runtime fields the reference injects into its Namespace
    device: str = "cuda"
    current_epoch: int = 0

    # the JAX package's additions (absent upstream, defaulted to be inert)
    mesh_data: int = -1  # -1: all devices on the data axis
    mesh_model: int = 1
    mesh_replica: int = 1  # multi-slice outer data parallelism (DCN axis)
    fsdp: bool = False  # shard params + AdamW moments over the data axis
    compute_dtype: str = "bfloat16"
    #: Adam moment storage: "float32" (reference parity) or "bfloat16"
    #: (half the optimizer state HBM/traffic; fp32 math either way).
    adam_moment_dtype: str = "float32"
    #: Log the global gradient L2 norm each step (the reference's
    #: ``wandb.watch(model, log="gradients")`` analog).
    log_grad_norm: bool = False
    #: GradCache microbatching: >1 splits each contrastive batch into this
    #: many chunks with EXACT big-batch InfoNCE semantics (~4/3 the FLOPs;
    #: use when the direct batch does not fit, e.g. ViT-L at bs512 on one
    #: card; ``training/grad_cache.py``).
    grad_cache_chunks: int = 1
    #: Preemption safety (the reference resumes only at epoch boundaries):
    #: >0 writes a mid-epoch step checkpoint every N steps; auto-resume
    #: continues the EXACT trajectory (deterministic loader fast-forward).
    save_every_n_steps: int = 0
    #: >0 exits cleanly after N steps this invocation, writing a step
    #: checkpoint when --save is set (slurm/maintenance-window budgets).
    max_steps: int = 0
    #: Write a profiler trace of a window of train steps to this dir; the
    #: window skips the warm-up steps (--profile_start_step, --profile_steps).
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_steps: int = 5
    remat: bool = False
    log_dir: Optional[str] = None
    data_backend: str = "threads"  # "threads" (PIL pool) | "tfdata" | "native" (C++ lib) | "grain"
    download_pretrained: bool = False  # fetch SHA-pinned OpenAI weights (needs egress)

    def run_key(self) -> str:
        """The `_BS{bs}_WD{wd}_LR{lr}_run{n}` naming rule of the reference's main.py."""
        return f"_BS{self.batch_size}_WD{self.wd}_LR{self.lr}_run{self.run}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="flyp_tpu_torch — FLYP on PyTorch and CUDA")
    d = ExperimentConfig()

    p.add_argument("--data-location", type=str, default=d.data_location, dest="data_location")
    p.add_argument("--eval-datasets", type=lambda x: x.split(","), default=None, dest="eval_datasets")
    p.add_argument("--train-dataset", default=None, dest="train_dataset")
    p.add_argument("--template", type=str, default=None)
    p.add_argument("--classnames", type=str, default="openai")
    p.add_argument("--alpha", nargs="*", type=float, default=[0.5])
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--results-db", type=str, default=None, dest="results_db")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=d.batch_size, dest="batch_size")
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--wd", type=float, default=d.wd)
    p.add_argument("--ls", type=float, default=d.ls)
    p.add_argument("--warmup_length", type=int, default=d.warmup_length)
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--load", type=lambda x: x.split(","), default=None)
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--freeze-encoder", action="store_true", dest="freeze_encoder")
    p.add_argument("--cache-dir", type=str, default=None, dest="cache_dir")
    p.add_argument("--fisher", type=lambda x: x.split(","), default=None)
    p.add_argument("--fisher_floor", type=float, default=d.fisher_floor)
    p.add_argument("--ft_data", type=str, default=None)
    p.add_argument("--ft_data_test", type=str, default=None)
    for flag in (
        "ce_ablation", "curriculum", "baseline", "cont_finetune", "progress_eval",
        "progress_train", "progress", "progress_validation", "ma_progress",
        "explore", "debug", "proportion", "test", "self_data",
    ):
        p.add_argument(f"--{flag}", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--progress_metric", type=str, default="Acc")
    p.add_argument("--cluster", type=str, default="")
    p.add_argument("--scheduler", type=str, default="default")
    p.add_argument("--datalimit", type=int, default=-1)
    p.add_argument("--curriculum_epoch", type=int, default=None)
    p.add_argument("--dataset-type", choices=["webdataset", "csv", "auto"], default="auto", dest="dataset_type")
    p.add_argument("--train-num-samples", type=int, default=None, dest="train_num_samples")
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--csv-separator", type=str, default="\t", dest="csv_separator")
    p.add_argument("--csv-img-key", type=str, default="filepath", dest="csv_img_key")
    p.add_argument("--csv-caption-key", type=str, default="title", dest="csv_caption_key")
    p.add_argument("--clip_load", type=str, default=None)
    p.add_argument("--wise_save", type=str, default=None)
    p.add_argument("--run", type=int, default=1)
    p.add_argument("--get_labeled_csv", action="store_true")
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--wandb_group_name", type=str, default="default")
    p.add_argument("--guidance", type=int, default=-1)
    p.add_argument("--slurm_job_id", type=int, default=-1)
    p.add_argument("--class_stats_path", type=str, default=None)
    p.add_argument("--cont_filter_key", type=str, default=d.cont_filter_key)
    p.add_argument("--cont_acc_threshold", type=float, default=d.cont_acc_threshold)
    p.add_argument("--cont_count_threshold", type=int, default=d.cont_count_threshold)
    # the JAX package's extras
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--mesh_replica", type=int, default=1)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--adam_moment_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--log_grad_norm", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--grad_cache_chunks", type=int, default=1)
    p.add_argument("--save_every_n_steps", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--profile_start_step", type=int, default=10)
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--data_backend", choices=["threads", "tfdata", "native", "grain"], default="threads")
    p.add_argument("--download_pretrained", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--fsdp", action=argparse.BooleanOptionalAction, default=False)
    return p


def parse_arguments(argv: Optional[List[str]] = None) -> ExperimentConfig:
    ns = build_parser().parse_args(argv)
    cfg = ExperimentConfig(**{k: v for k, v in vars(ns).items()})
    if cfg.load is not None and len(cfg.load) == 1:
        cfg.load = cfg.load[0]
    return cfg
