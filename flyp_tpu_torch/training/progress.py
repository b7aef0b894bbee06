"""Progress-validation beam search over guidance sequences.

Counterpart of ``flyp_tpu/training/progress.py`` (the reference's
``flyp_loss_progress.py``): snapshot the initial model; for each beam round,
take each surviving snapshot, rank the guidance values by their progress
on the guidance CSV, train one full pass on each guidance from the same
snapshot, evaluate the suite, and keep the ``beam_size`` best (model,
optimizer, progress baseline) by the selection metric (IWildCamOOD
macro-F1 by default).

Snapshots are the port's trainer checkpoints (``utils/checkpoint.py``:
parameters, AdamW moments and count, BatchNorm running statistics) with
the JAX package's ``<path>.perform.json`` sidecar (``{"last_perform",
"step"}``); a candidate's state is held as a host copy until the round's
best are written.  The TSV files carry the JAX package's names.  The
protocol is a single process's.
"""

from __future__ import annotations

import copy
import json
import os
import shutil

import numpy as np
import torch

from flyp_tpu_torch.data.csv_data import get_csv_loader
from flyp_tpu_torch.evaluation.classifier import Classifier
from flyp_tpu_torch.evaluation.evaluator import evaluate
from flyp_tpu_torch.parallel.multihost import process_count
from flyp_tpu_torch.tokenizer import shrink_context
from flyp_tpu_torch.training.flyp import _avg_ood_acc, _write_tsv, build_zeroshot_head, progress_eval
from flyp_tpu_torch.training.schedules import make_scheduler
from flyp_tpu_torch.training.train_state import TrainState, create_train_state, make_optimizer
from flyp_tpu_torch.training.train_step import make_train_step
from flyp_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from flyp_tpu_torch.utils.pipeline import OneStepLag, host_cast_images, to_device


def _save_snapshot(path: str, state: TrainState, last_perform: dict, step: int) -> str:
    """A trainer checkpoint of ``state`` at ``path`` and its JSON sidecar
    (the progress baseline, a {stat name: float} dict, and the step)."""
    save_checkpoint(path, state)
    with open(path + ".perform.json", "w") as f:
        json.dump({"last_perform": last_perform, "step": int(step)}, f)
    return path


def _remove_snapshot(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)
    sidecar = path + ".perform.json"
    if os.path.exists(sidecar):
        os.remove(sidecar)


def _restore(path: str, state: TrainState):
    """Load the snapshot at ``path`` into ``state``: ``(state, last_perform,
    step)``."""
    with open(path + ".perform.json") as f:
        meta = json.load(f)
    state, _ = restore_checkpoint(path, state)
    return state, meta["last_perform"], meta["step"]


def _host_copy(state: TrainState) -> dict:
    """The state's tensors (parameters, running statistics, moments,
    count), copied to the host."""
    cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    opt = state.opt_state
    return {"model": {k: cpu(v) for k, v in state.model.state_dict().items()}, "count": cpu(opt.count),
            "mu": [cpu(m) for m in opt.mu], "nu": [cpu(v) for v in opt.nu], "step": state.step}


@torch.no_grad()
def _load_host_copy(state: TrainState, host: dict) -> TrainState:
    state.model.load_state_dict(host["model"])
    opt = state.opt_state
    opt.count.copy_(host["count"])
    torch._foreach_copy_(opt.mu, [m.to(t.device) for m, t in zip(host["mu"], opt.mu)])
    torch._foreach_copy_(opt.nu, [v.to(t.device) for v, t in zip(host["nu"], opt.nu)])
    state.step = host["step"]
    return state


def flyp_progress_validation(
    cfg,
    logger,
    model=None,
    beam_size: int = 5,
    num_rounds: int = 2,
    select_metric: str = "IWildCamOODF1-macro_all",
):
    """Run the beam search; returns the surviving snapshots' paths.
    ``model`` defaults to ``build_clip_model(cfg, device=cfg.device)``."""
    if cfg.train_dataset is None:
        raise AssertionError("Please provide a training dataset.")
    if cfg.save is None:
        raise AssertionError("progress validation needs --save for snapshots")
    if process_count() > 1:
        # Batches feed the step with no global assembly, and every process
        # would race on the snapshot paths.
        raise NotImplementedError("progress validation is a single-process protocol; run it in one process")
    logger.info("Fine-tuning Using FLYP Loss (progress validation)")

    log_dir = cfg.log_dir or os.path.join("expt_logs", cfg.exp_name or "progress", cfg.run_key())
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(cfg.save, exist_ok=True)

    if model is None:
        from flyp_tpu_torch.models.factory import build_clip_model

        model = build_clip_model(cfg, device=cfg.device)
    device = model.device
    image_size = model.config.vision.image_size

    if cfg.scheduler not in ("default", "drestart"):
        raise ValueError(f"invalid scheduler type {cfg.scheduler}!")
    schedule = make_scheduler(cfg.scheduler, cfg.lr, cfg.warmup_length, cfg.epochs, 1000, cfg.min_lr)
    optimizer = make_optimizer(schedule, cfg.wd, cfg.adam_moment_dtype)
    state = create_train_state(model, optimizer)
    step_fn = make_train_step(model, optimizer)

    def train_on_guidance(state, guid, step):
        # Replicated: the batches feed the step directly.
        loader = get_csv_loader(cfg, is_train=True, image_size=image_size, guidance=guid, shard_by_process=False)
        loss_sum, batches = 0.0, 0
        lag = OneStepLag()  # step i's loss is fetched after step i+1 is launched
        for batch in loader:
            # Exact context shrinking, as the trainer's loader does.
            tokens = torch.from_numpy(shrink_context(np.asarray(batch["tokens"])))
            images = host_cast_images(batch["image"], model.compute_dtype)
            state, metrics = step_fn(state, to_device(images, device), to_device(tokens, device))
            prev = lag.push(metrics)
            if prev is not None:
                loss_sum += float(prev["loss"])
            step += 1
            batches += 1
        prev = lag.flush()
        if prev is not None:
            loss_sum += float(prev["loss"])
        return state, step, loss_sum / max(batches, 1)

    # 0. The starting point.
    init_path = os.path.join(cfg.save, "cur_point-1_guidpath-1")
    _save_snapshot(init_path, state, {}, 0)
    logger.info("Saving model to " + init_path)

    stats = []
    beam = [init_path]
    epoch = -1
    while epoch < num_rounds - 1:
        epoch += 1
        candidates = []
        for last_path in beam:
            last_name = os.path.basename(last_path)
            last_guid_path_str = last_name.split("guidpath")[1]

            state, last_perform, step = _restore(last_path, state)
            res_progress, str_progress, last_perform, _ = progress_eval(cfg, model, last_perform, epoch, logger)
            ranked = sorted(res_progress.items(), key=lambda kv: kv[1], reverse=True)
            row = {**str_progress, "epoch": epoch}
            _write_tsv(os.path.join(log_dir, f"progress{epoch}_before_guidpath{last_guid_path_str}.tsv"),
                       list(row), [{0: v} for v in row.values()], [0])

            for guid, _progress in ranked:
                epoch_stats = {"last_model_name": last_name, "epoch": epoch}
                state, last_perform, step = _restore(last_path, state)

                cur_guid_path = last_guid_path_str.split("=") + [str(guid)]
                cur_guid_path_str = "=".join(cur_guid_path)

                state, step, id_flyp_loss_avg = train_on_guidance(state, guid, step)

                _, str_progress, last_perform, _ = progress_eval(cfg, model, last_perform, epoch, logger)
                row = {**str_progress, "epoch": epoch}
                _write_tsv(os.path.join(log_dir, f"progress{epoch}_after_guidpath{cur_guid_path_str}.tsv"),
                           list(row), [{0: v} for v in row.values()], [0])

                head = build_zeroshot_head(cfg, model)
                evaluate(Classifier(model, head, batch_size=cfg.batch_size), cfg, epoch_stats, logger)

                epoch_stats["Trained_guid"] = guid
                epoch_stats["Avg OOD Acc"] = round(_avg_ood_acc(epoch_stats), 4)
                epoch_stats["Avg ID FLYP Loss"] = round(id_flyp_loss_avg, 4)
                epoch_stats = {k: v for k, v in epoch_stats.items() if " Class" not in k}

                score = epoch_stats.get(select_metric, epoch_stats.get("Avg OOD Acc", 0.0))
                candidates.append({
                    "epoch": epoch,
                    "guid": guid,
                    "last_perform": copy.deepcopy(last_perform),
                    "guid_path": cur_guid_path_str,
                    "step": step,
                    "score": score,
                    "state": _host_copy(state),
                })
                stats.append(epoch_stats)
                _write_tsv(os.path.join(log_dir, f"stats{epoch}_after_guidpath{cur_guid_path_str}.tsv"),
                           range(len(stats)), stats)

        for old in beam:
            _remove_snapshot(old)
        candidates = sorted(candidates, key=lambda c: c["score"], reverse=True)[:beam_size]
        beam = []
        for cand in candidates:
            path = os.path.join(cfg.save, f"cur_point{epoch}_guidpath{cand['guid_path']}")
            _save_snapshot(path, _load_host_copy(state, cand["state"]), cand["last_perform"], cand["step"])
            logger.info("Saving model to " + path)
            beam.append(path)
        logger.info(f"Saved top-{beam_size} model: {beam}")

    return beam
