"""The FLYP trainer: contrastive fine-tuning with a zero-shot evaluation
after every epoch.

Counterpart of ``flyp_tpu/training/flyp.py``:

* the train step (``training/train_step.py``: both towers, the global-batch
  InfoNCE, AdamW; ``--grad_cache_chunks N`` its chunked form,
  ``training/grad_cache.py``) fed by the CSV or tar-shard loader through the
  pinned prefetch (``training/data.py``);
* the curriculum (guidance sequencing, the ``curriculum_epoch`` budget and
  its ``drestart`` rollover, progress-driven selection with 15%
  exploration, proportion mixing, loss-pair clustering), as the JAX
  trainer keeps it;
* per epoch: a checkpoint (params, a ModifiedResNet's BatchNorm running
  statistics, AdamW state, curriculum cursor and host state;
  ``utils/checkpoint.py``), a zero-shot head rebuilt from the trained text
  tower, the evaluation suites (in eval mode: BatchNorm on the running
  statistics the training left in the model, which the JAX trainer passes
  as its host variables' ``batch_stats``), and ``class_stats{n}.tsv`` and
  ``stats.tsv`` with the JAX trainer's file names and columns;
* step checkpoints (``--save_every_n_steps``) and a clean step budget
  (``--max_steps``), from which an automatic resume continues the
  uninterrupted run's trajectory bit for bit.

The TSV files are written as pandas writes them (the port reads and writes
them without pandas).

Several processes (``cli/main.py`` under ``torchrun``, one rank a device)
train one model on a mesh (``parallel/mesh.py``, from ``--mesh_data``,
``--mesh_model`` and ``--mesh_replica``, the data axis capped to divide the
batch): the batch splits over the data (and replica) axis, each input group
loading its rows (``parallel/multihost.py``); ``--mesh_model > 1`` shards
the transformer blocks head-group-wise (``parallel/tp.py``), else
``--fsdp`` shards parameters and moments over the data axis
(``parallel/fsdp.py``), else every rank holds the whole state.  Every rank
evaluates the whole eval sets (replicated loaders) and calls the checkpoint
saves, which gather the shards; rank 0 alone writes files.
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flyp_tpu_torch.data.csv_data import get_csv_loader
from flyp_tpu_torch.data.csv_dataset import read_table
from flyp_tpu_torch.data.registry import get_classnames_for
from flyp_tpu_torch.evaluation.classifier import Classifier
from flyp_tpu_torch.evaluation.evaluator import evaluate
from flyp_tpu_torch.evaluation.zeroshot import get_zeroshot_classifier
from flyp_tpu_torch.parallel.mesh import MeshConfig, batch_axes, create_mesh_for_batch
from flyp_tpu_torch.parallel.multihost import (configure_input_sharding, is_primary, process_count,
                                               reset_input_sharding)
from flyp_tpu_torch.templates import get_template
from flyp_tpu_torch.training.curriculum import choose_guidance_by_progress, init_guidance_setting, seq_curri_guid
from flyp_tpu_torch.training.data import check_resumable, device_iter, train_loader
from flyp_tpu_torch.training.schedules import make_scheduler
from flyp_tpu_torch.training.train_state import create_train_state, make_optimizer
from flyp_tpu_torch.training.train_step import make_train_step
from flyp_tpu_torch.utils.checkpoint import (CurriculumCursor, StepCursor, restore_checkpoint, save_checkpoint,
                                             wait_for_saves)
from flyp_tpu_torch.utils.logging import get_logger
from flyp_tpu_torch.utils.metrics_sink import MetricsSink
from flyp_tpu_torch.utils.pipeline import OneStepLag
from flyp_tpu_torch.utils.profiling import StepWindowTrace


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


# -- TSV files as pandas' ``DataFrame.to_csv(sep="\t")`` writes them ---------


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _column_format(values: list):
    """How pandas prints one column of a frame built from Python values:
    integers stay integers unless the column also holds floats or a
    missing value (float64 then), floats print as their shortest repr,
    missing values as the empty string."""
    present = [v for v in values if not _is_missing(v)]
    numbers = all(isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool) for v in present)
    if numbers and present and (len(present) < len(values) or any(isinstance(v, (float, np.floating))
                                                                    for v in present)):
        return lambda v: "" if _is_missing(v) else repr(float(v))
    return lambda v: "" if _is_missing(v) else str(int(v) if isinstance(v, np.integer) else v)


def _write_tsv(path: str, index: Sequence, rows: Sequence[Dict], columns: Optional[Sequence] = None) -> None:
    """``pd.DataFrame(rows, index=index, columns=columns).to_csv(path,
    sep="\\t")`` for rows of scalars; ``columns`` defaults to the keys in
    order of first appearance."""
    if columns is None:
        columns = list(dict.fromkeys(k for r in rows for k in r))
    cells = [[r.get(c) for r in rows] for c in columns]
    formats = [_column_format(col) for col in cells]
    lines = ["\t".join(["", *map(str, columns)])]
    for i, label in enumerate(index):
        lines.append("\t".join([str(label), *(fmt(col[i]) for fmt, col in zip(formats, cells))]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _read_tsv(path: str):
    """``(index, rows)`` of a TSV written with an index column, the cells
    typed as ``pd.read_csv(path, sep="\\t", index_col=0)`` types them."""
    table = read_table(path, "\t")
    names = list(table)
    index, rest = table[names[0]], names[1:]
    return index, [{k: table[k][i] for k in rest} for i in range(len(index))]


# -- epoch artifacts ---------------------------------------------------------


def progress_eval(cfg, model, last_perform, epoch, logger, progress_ma=None):
    """Per-guidance eval of the guidance CSV: each guidance's accuracy (or
    F1) and its change since ``last_perform``."""
    head = build_zeroshot_head(cfg, model)
    clf = Classifier(model, head, batch_size=cfg.batch_size)
    eval_data = get_csv_loader(cfg, is_train=False, image_size=model.config.vision.image_size, return_guidance=True)
    stats: dict = {}
    evaluate(clf, cfg, stats, logger, progress_eval=True, eval_batch_loader=eval_data)

    keyword = "Accuracy" if cfg.progress_metric == "Acc" else "F1"
    res_progress, str_progress, cur_stats = {}, {}, {}
    for key, value in stats.items():
        if "Number" in key or keyword not in key:
            continue
        last = last_perform.get(key, 0)
        guid = int(key.replace("Strength ", "").replace("Guidance ", "").replace(" Accuracy", "").replace(" F1", ""))
        if cfg.ma_progress and progress_ma is not None:
            progress_ma.setdefault(guid, []).append(value)
            value = float(np.mean(progress_ma[guid]))
        str_progress[f"Guidance {guid}"] = round(value - last, 6)
        res_progress[guid] = value - last
        cur_stats[guid] = value
    return res_progress, str_progress, dict(stats), cur_stats


def progress_eval_train(cfg, model, epoch, logger, progress_ma=None):
    """Each training image's best guidance: the one whose caption the model
    gives the highest probability."""
    head = build_zeroshot_head(cfg, model)
    clf = Classifier(model, head, batch_size=cfg.batch_size)
    data = get_csv_loader(
        cfg, is_train=False, image_size=model.config.vision.image_size,
        return_guidance=True, return_img_id=True, only_img_id=True,
    )
    dict_preds: dict = {}
    for batch in data.test_loader:
        logits = clf.predict_logits(batch["image"])
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        for i in range(len(batch["label"])):
            img_id = int(batch["img_id"][i])
            dict_preds.setdefault(img_id, []).append(
                [int(batch["guidance"][i]), float(probs[i, int(batch["label"][i])])]
            )

    dict_best_guid = {}
    for img_id, pairs in dict_preds.items():
        if cfg.ma_progress and progress_ma is not None:
            progress_ma.setdefault(img_id, []).extend(pairs)
            merged = progress_ma[img_id]
            pairs = [
                [g, float(np.mean([p for gg, p in merged if gg == g]))]
                for g in {g for g, _ in merged}
            ]
        dict_best_guid[img_id] = sorted(pairs, key=lambda x: x[-1], reverse=True)[0][0]
    return dict_best_guid


def _avg_ood_acc(epoch_stats: dict) -> float:
    """Mean accuracy over the eval sets, skipping the literal 'ImageNet
    Accuracy' key, as the reference does."""
    ood_acc, num = 0.0, 0
    for k, v in epoch_stats.items():
        if "Accuracy" in k and "Class" not in k and "Guidance" not in k:
            if k == "ImageNet Accuracy":
                continue
            ood_acc += v
            num += 1
    return ood_acc / num if num else 0.0


def _write_class_stats(epoch_stats: dict, eval_datasets, log_dir: str, epoch: int) -> None:
    """``class_stats{epoch}.tsv``: per class, each dataset's accuracy and
    count columns."""
    ind = {k: i for i, k in enumerate(eval_datasets)}
    class_stats: dict = {}
    for k, v in epoch_stats.items():
        if " Class " not in k:
            continue
        ds_name, rest = k.split(" Class ", 1)
        row = None
        if "Accuracy" in rest:
            row, col = f"Class {rest.replace(' Accuracy', '')}", 2 * ind[ds_name]
        elif "Number" in rest:
            row, col = f"Class {rest.replace(' Number', '')}", 2 * ind[ds_name] + 1
        if row is not None:
            class_stats.setdefault(row, [0] * 2 * len(eval_datasets))[col] = v
    columns = []
    for name in eval_datasets:
        columns += [name, name + " Count"]
    _write_tsv(os.path.join(log_dir, f"class_stats{epoch}.tsv"), list(class_stats),
               [dict(zip(columns, values)) for values in class_stats.values()], columns)


def _cont_finetune_classes(cfg, logger):
    """Class filter for ``--cont_finetune``: a prior run's
    ``class_stats{n}.tsv``, keeping the classes whose accuracy stayed at or
    below ``cont_acc_threshold`` with at least ``cont_count_threshold``
    examples; class 0 is always kept.  The prior checkpoint itself comes
    through ``--clip_load``."""
    if not cfg.class_stats_path:
        raise ValueError("--cont_finetune needs --class_stats_path (a prior run's class_stats{n}.tsv)")
    index, rows = _read_tsv(cfg.class_stats_path)
    acc_col, count_col = cfg.cont_filter_key, f"{cfg.cont_filter_key} Count"
    list_classes = [int(str(ix).replace("Class ", "")) for ix, r in zip(index, rows)
                    if r[acc_col] <= cfg.cont_acc_threshold and r[count_col] >= cfg.cont_count_threshold]
    if 0 not in list_classes:
        list_classes.append(0)
    logger.info(f"Only continuing finetune ckpt based on {len(list_classes)} classes: {list_classes}")
    return list_classes


# -- checkpoint names ----------------------------------------------------------


def _parse_checkpoint_name(d: str):
    """``checkpoint_{e}[_step_{i}]`` -> ``(ordering_key, kind)`` or None.

    ``checkpoint_{e}`` means "epoch e completed" and orders as ``(e+1,
    -1)``; ``checkpoint_{e}_step_{i}`` means "epoch e, step i completed"
    and orders as ``(e, i)``.  The temporary directories of a save in
    progress (``<name>.tmp-*``) fail the digit guards."""
    if not d.startswith("checkpoint_"):
        return None
    e, sep, s = d[len("checkpoint_"):].partition("_step_")
    if not e.isdigit():
        return None
    if not sep:
        return (int(e) + 1, -1), "epoch"
    if s.isdigit():
        return (int(e), int(s)), "step"
    return None


def _latest_checkpoint(save_dir: str):
    """The newest checkpoint in ``save_dir``: ``(kind, path)`` or None."""
    best = None
    for d in os.listdir(save_dir):
        parsed = _parse_checkpoint_name(d)
        if parsed is None:
            continue
        key, kind = parsed
        if best is None or key > best[0]:
            best = (key, (kind, os.path.join(save_dir, d)))
    return best[1] if best else None


def _prune_step_checkpoints(save_dir: str, keep: int = 2) -> None:
    """Delete superseded step checkpoints, keeping the ``keep`` newest;
    epoch checkpoints are never touched.  The save in progress is not yet
    under its name, so the newest kept is committed."""
    entries = []
    for d in os.listdir(save_dir):
        parsed = _parse_checkpoint_name(d)
        if parsed is not None and parsed[1] == "step":
            entries.append((parsed[0], os.path.join(save_dir, d)))
    for _, path in sorted(entries)[: max(0, len(entries) - keep)]:
        shutil.rmtree(path, ignore_errors=True)


def build_mesh(cfg):
    """The trainer's mesh: ``--mesh_data``/``--mesh_model``/``--mesh_replica``
    over the ranks, the data axis capped to divide the batch.  Every rank
    must be in it: a rank the cap leaves out would have no work and would
    hang the others' collectives."""
    mesh = create_mesh_for_batch(MeshConfig(cfg.mesh_data, cfg.mesh_model, getattr(cfg, "mesh_replica", 1)),
                                 cfg.batch_size)
    if mesh.size != process_count():
        raise ValueError(f"the mesh {mesh} for batch_size {cfg.batch_size} covers {mesh.size} of "
                         f"{process_count()} ranks; launch {mesh.size} processes or change the batch or the mesh")
    return mesh


def place_state(cfg, mesh, state):
    """Place a fresh ``TrainState`` on ``mesh`` as the JAX trainer does:
    tensor-parallel when the model axis is larger than 1, else FSDP with
    ``--fsdp``, else whole on every rank."""
    if mesh.shape["model"] > 1:
        from flyp_tpu_torch.parallel.tp import shard_train_state

        return shard_train_state(mesh, state)
    if cfg.fsdp:
        from flyp_tpu_torch.parallel.fsdp import shard_train_state_fsdp

        return shard_train_state_fsdp(mesh, state)
    state.mesh = mesh
    return state


def _gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's rows of a per-rank tensor (``--cluster loss``'s
    per-item losses and image ids), in batch order, on every rank."""
    from flyp_tpu_torch.parallel.comm import all_gather

    return all_gather(t.reshape(-1), mesh.group(batch_axes(mesh)))


def _saves_committed() -> None:
    """Wait for this process's pending checkpoint commit, then (several
    ranks) for every rank's: rank 0 writes, and no rank returns a
    checkpoint path before the checkpoint is on disk."""
    wait_for_saves()
    if process_count() > 1:
        import torch.distributed as dist

        dist.barrier()


def _host_blob(last_perform, explore_rng, loss_pairs, progress_ma) -> dict:
    return {
        "last_perform": last_perform,
        "explore_rng": explore_rng.bit_generator.state,
        "loss_pairs": loss_pairs,
        "progress_ma": {str(k): v for k, v in progress_ma.items()},
    }


def flyp_train(cfg, logger=None, model=None, print_every: int = 100):
    """Run FLYP fine-tuning; returns the last checkpoint path (if saving).

    ``model`` defaults to ``build_clip_model(cfg, device=cfg.device)``.
    With several ranks every one calls it (module docstring)."""
    mesh = build_mesh(cfg)
    log_dir = cfg.log_dir or os.path.join("expt_logs", cfg.exp_name or "flyp", cfg.run_key())
    os.makedirs(log_dir, exist_ok=True)
    logger = logger or get_logger(log_dir)
    primary = is_primary()
    sink = MetricsSink(
        log_dir, enabled=not cfg.debug and primary, config=vars(cfg), name=cfg.exp_name, group=cfg.wandb_group_name
    )

    if model is None:
        from flyp_tpu_torch.models.factory import build_clip_model

        model = build_clip_model(cfg, device=cfg.device)
    device = model.device
    image_size = model.config.vision.image_size
    logger.info(f"Mesh: {mesh}")
    # The input grid follows the mesh (on a TP mesh a model group loads the
    # same rows); it is unpinned on every way out.
    configure_input_sharding(mesh)
    try:
        return _train(cfg, logger, model, print_every, log_dir, sink, primary, device, image_size, mesh)
    finally:
        reset_input_sharding()


def _train(cfg, logger, model, print_every, log_dir, sink, primary, device, image_size, mesh):
    list_classes = _cont_finetune_classes(cfg, logger) if cfg.cont_finetune else None

    guid = init_guidance_setting(cfg, logger, list_classes=list_classes)
    cur_guidance_id, cur_guidance = guid.cur_guidance_id, guid.cur_guidance
    list_guidance, loop_times = guid.list_guidance, guid.loop_times
    cur_str_times = 1

    ori_proportion = 0.1 if cfg.proportion else None
    check_resumable(cfg)

    def load_train_loader(epoch, guidance, str_times, proportion, log_row=True):
        if guidance is not None and log_row:
            logger.info(f"loading image guidance = {guidance}, loop times {str_times}")
            sink.log({"Epoch": epoch, "Image Guidance": guidance})
        return train_loader(cfg, image_size, guidance=guidance, proportion=proportion, list_classes=list_classes,
                            return_img_id=(cfg.cluster == "loss"))

    # A pending resume is found first, so that the epoch-0 loader is built
    # quietly: the resume rebuilds the loader from the restored cursor, and
    # an "Image Guidance" row for this one would be a spurious entry.  The
    # loader is still built: the scheduler's horizon comes from the epoch-0
    # loader, as in the uninterrupted run.
    resume_found = _latest_checkpoint(cfg.save) if cfg.save is not None and os.path.isdir(cfg.save) else None
    ft_loader = load_train_loader(0, cur_guidance, cur_str_times, ori_proportion, log_row=resume_found is None)
    num_batches = len(ft_loader)
    if cfg.curriculum:
        if cfg.curriculum_epoch is None:
            num_batches = (
                int(guid.len_data / cfg.batch_size) if guid.len_data is not None
                else num_batches * len(list_guidance)
            )
        else:
            num_batches = guid.num_batch_ori
    logger.info(f"Num batches is {num_batches}")

    schedule = make_scheduler(cfg.scheduler, cfg.lr, cfg.warmup_length, cfg.epochs, num_batches, cfg.min_lr)
    optimizer = make_optimizer(schedule, cfg.wd, cfg.adam_moment_dtype)
    state = place_state(cfg, mesh, create_train_state(model, optimizer))
    multi = mesh.size > 1

    def build_step(optimizer):
        return make_train_step(model, optimizer, log_grad_norm=cfg.log_grad_norm,
                               freeze_encoder=cfg.freeze_encoder, grad_cache_chunks=cfg.grad_cache_chunks,
                               mesh=mesh if multi else None)

    def whole_model():
        """The model with its whole parameters (FSDP gathers its shards):
        what the head, the evaluation and the progress probes read."""
        if state.shards is not None:
            from flyp_tpu_torch.parallel.fsdp import materialize

            materialize(state)
        return model

    step_fn = build_step(optimizer)

    explore_rng = np.random.default_rng(cfg.seed)
    stats: List[dict] = []
    last_perform: dict = {}
    loss_pairs: list = []
    resume_progress_ma: dict = {}  # a mid-epoch resume restores the moving averages
    model_path = None
    start_epoch = 0

    # Resume from the newest checkpoint in --save.  Step checkpoints carry
    # a StepCursor: the resumed run rebuilds the loader pass it was in,
    # skips the consumed batches and restores the partial loss sum; every
    # checkpoint carries the host state (progress's last_perform and
    # exploration RNG, --cluster loss's pairs, --ma_progress's averages).
    data_pass = 0
    batch_in_pass = 0
    cur_proportion = ori_proportion  # the active loader's ori_proportion
    resume_epoch_mid = -1  # epoch being resumed mid-way (-1: none)
    resume_step = 0  # first step index to run in that epoch
    resume_loss_sum = 0.0
    if resume_found is not None:
        kind, path = resume_found
        logger.info(f"Auto-resuming from {path}")
        if kind == "step":
            state, cursor, mid_cursor, host_blob = restore_checkpoint(path, state, mid=True, host=True)
        else:
            state, cursor, host_blob = restore_checkpoint(path, state, host=True)
        if host_blob is not None:
            last_perform = host_blob["last_perform"]
            loss_pairs = [list(p) for p in host_blob["loss_pairs"]]
            explore_rng.bit_generator.state = host_blob["explore_rng"]
            resume_progress_ma = {int(k): v for k, v in host_blob["progress_ma"].items()}
        elif cfg.progress:
            logger.warning(
                "auto-resume with --progress from a checkpoint without host state: last_perform and the "
                "exploration RNG restart; progress-driven guidance choices may diverge from an uninterrupted run"
            )
        cur_guidance = cursor.cur_guidance
        cur_str_times = cursor.cur_str_times
        cur_guidance_id = cursor.cur_guidance_id
        if kind == "step":
            start_epoch = cursor.epoch
            resume_epoch_mid = cursor.epoch
            resume_step = mid_cursor.step_in_epoch + 1
            resume_loss_sum = mid_cursor.id_flyp_loss_sum
            data_pass = mid_cursor.data_pass
            batch_in_pass = mid_cursor.batch_in_pass
            cur_proportion = None if mid_cursor.proportion < 0 else mid_cursor.proportion
            # The pass the interrupted run was in, past its consumed batches;
            # its "Image Guidance" row is in the metrics stream already.
            ft_loader = load_train_loader(start_epoch, cur_guidance, cur_str_times, cur_proportion, log_row=False)
            ft_loader.set_epoch(data_pass, start_batch=batch_in_pass)
        else:
            start_epoch = cursor.epoch + 1
            if cfg.curriculum and cur_guidance is not None:
                ft_loader = load_train_loader(start_epoch, cur_guidance, cur_str_times, ori_proportion)
            elif cur_guidance is not None:
                # Fixed-guidance runs keep the quietly built epoch-0 loader:
                # log the row its build left out.
                logger.info(f"loading image guidance = {cur_guidance}, loop times {cur_str_times}")
                sink.log({"Epoch": start_epoch, "Image Guidance": cur_guidance})
        # stats.tsv is rewritten from memory at each epoch's end: reload the
        # completed epochs' rows (iterrows' types: the row's values as
        # floats, the epochs as ints, missing cells dropped).
        stats_path = os.path.join(log_dir, "stats.tsv")
        if os.path.isfile(stats_path):
            for row in _read_tsv(stats_path)[1]:
                if not row.get("Epoch", -1) < start_epoch:
                    continue
                r = {k: v for k, v in row.items() if not _is_missing(v)}
                if all(isinstance(v, (int, float)) for v in r.values()):
                    r = {k: float(v) for k, v in r.items()}
                for k in ("Epoch", "epoch"):
                    if k in r:
                        r[k] = int(r[k])
                stats.append(r)

    drestart_done = False
    steps_this_run = 0
    prof = StepWindowTrace(cfg.profile_dir, cfg.profile_start_step, cfg.profile_steps)
    ft_iterator = device_iter(ft_loader, device, cfg.compute_dtype)

    try:
        for epoch in range(start_epoch, cfg.epochs):
            # The curriculum_epoch rollover to guidance-100 training.
            if cfg.curriculum_epoch is not None and epoch >= cfg.curriculum_epoch:
                if cfg.scheduler == "drestart" and not drestart_done:
                    # Only the schedule restarts: the moments and the count
                    # stay.  Its horizon is epochs - curriculum_epoch whatever
                    # epoch a run resumed at.
                    drestart_done = True
                    logger.info("Restart scheduler")
                    schedule_r = make_scheduler(
                        "default", cfg.lr, cfg.warmup_length,
                        max(cfg.epochs - cfg.curriculum_epoch, 1), num_batches, cfg.min_lr,
                    )
                    optimizer = make_optimizer(schedule_r, cfg.wd, cfg.adam_moment_dtype)
                    step_fn = build_step(optimizer)
                if cur_guidance != 0 and cur_guidance != 100:
                    logger.info("Restart dataloader")
                    cur_guidance = 100
                    cur_guidance_id = list_guidance.index(100)
                    cur_str_times = 1
                    ft_loader = load_train_loader(epoch, cur_guidance, cur_str_times, None)
                    # A new pass: a step checkpoint inside it rebuilds this loader.
                    cur_proportion = None
                    data_pass += 1
                    batch_in_pass = 0
                    ft_loader.set_epoch(data_pass)
                    ft_iterator = device_iter(ft_loader, device, cfg.compute_dtype)

            logger.info(f"Epoch : {epoch}")
            epoch_stats = {"Epoch": epoch, "epoch": epoch}
            progress_ma: dict = resume_progress_ma if epoch == resume_epoch_mid else {}
            start_step = resume_step if epoch == resume_epoch_mid else 0
            id_flyp_loss_sum = resume_loss_sum if epoch == resume_epoch_mid else 0.0

            # Step i's metrics are fetched after step i+1 is launched, so the
            # fetch overlaps device work; the non-finite-loss guard fires one
            # step late.
            lag = OneStepLag()  # (step index, device metrics, device img_ids for clustering)

            def drain_metrics(pend):
                nonlocal id_flyp_loss_sum
                j, m, img_ids = pend
                # One transfer a step: the scalars, and for clustering the
                # per-item losses and image ids (float64 holds each exactly).
                parts = [m["loss"], m["learning_rate"]] + ([m["grad_norm"]] if "grad_norm" in m else [])
                parts = [p.reshape(1).double() for p in parts]
                if img_ids is not None:
                    per_item, ids = m["per_item_loss"].reshape(-1).double(), img_ids.reshape(-1).double()
                    if multi:
                        # Each rank holds its rows: the global batch's, in
                        # order, on every rank (a collective).
                        per_item, ids = _gather_rows(per_item, mesh), _gather_rows(ids, mesh)
                    parts += [per_item, ids]
                host = torch.cat(parts).cpu().tolist()
                loss_val, lr = host[0], host[1]
                if not np.isfinite(loss_val):
                    raise FloatingPointError(f"non-finite loss {loss_val} at epoch {epoch} step {j}; lr={lr:.3e}")
                id_flyp_loss_sum += loss_val
                if img_ids is not None:
                    n = img_ids.numel()
                    per_item = host[-2 * n:-n]
                    loss_pairs.extend(zip((int(v) for v in host[-n:]), per_item))
                record = {"Epoch": epoch, "ID FLYP Loss": loss_val, "Learning Rate": lr}
                if "grad_norm" in m:
                    record["Gradient Norm"] = host[2]
                sink.log(record)
                if j % print_every == 0:
                    pct = 100 * j / num_batches
                    logger.info(f"Train Epoch: {epoch} [{pct:.0f}% {j}/{num_batches}]\tID FLYP Loss: {loss_val:.4f}")

            for i in range(start_step, num_batches):
                if cfg.test:
                    logger.info("Skipping training process")
                    break

                try:
                    batch = next(ft_iterator)
                    batch_in_pass += 1
                except StopIteration:
                    proportion = None
                    if cfg.curriculum:
                        if cfg.curriculum_epoch is not None and epoch > cfg.curriculum_epoch:
                            cur_guidance = 100
                            cur_guidance_id = list_guidance.index(100)
                            cur_str_times = 1
                        else:
                            if not cfg.progress:
                                if cfg.curriculum_epoch is None:
                                    cur_guidance_id, cur_guidance = seq_curri_guid(
                                        list_guidance, cur_guidance_id=cur_guidance_id, ctype="no_curri"
                                    )
                                else:
                                    cur_guidance_id, cur_guidance, cur_str_times = seq_curri_guid(
                                        list_guidance,
                                        cur_guidance_id=cur_guidance_id,
                                        cur_str_times=cur_str_times,
                                        ctype="in_curri",
                                        loop_times=loop_times,
                                    )
                            else:
                                res_progress, _, last_perform, _ = progress_eval(
                                    cfg, whole_model(), last_perform, epoch, logger
                                )
                                cur_guidance_id, cur_guidance = choose_guidance_by_progress(
                                    res_progress, list_guidance, cfg.explore, explore_rng
                                )
                                cur_str_times = 0
                            if cfg.proportion and cfg.curriculum_epoch:
                                proportion = 1 / cfg.curriculum_epoch * epoch
                        ft_loader = load_train_loader(epoch, cur_guidance, cur_str_times, proportion)
                        cur_proportion = proportion
                    # Each pass draws a new shuffle.
                    data_pass += 1
                    ft_loader.set_epoch(data_pass)
                    ft_iterator = device_iter(ft_loader, device, cfg.compute_dtype)
                    try:
                        batch = next(ft_iterator)
                    except StopIteration:
                        raise RuntimeError(
                            f"train loader for guidance {cur_guidance} produced no batches (fewer than "
                            f"batch_size={cfg.batch_size} rows after guidance/class filtering?)"
                        ) from None
                    batch_in_pass = 1

                prof.step(steps_this_run)
                state, metrics = step_fn(state, batch["image"], batch["tokens"])
                prev = lag.push((i, metrics, batch["img_id"] if cfg.cluster == "loss" else None))
                if prev is not None:
                    drain_metrics(prev)  # step i is in flight; the fetch of i-1 overlaps it

                # Step checkpoints and the step budget.
                steps_this_run += 1
                hit_budget = bool(cfg.max_steps) and steps_this_run >= cfg.max_steps
                periodic = (
                    cfg.save is not None
                    and cfg.save_every_n_steps
                    and (i + 1) % cfg.save_every_n_steps == 0
                    and i + 1 < num_batches  # the epoch checkpoint follows anyway
                )
                if hit_budget or periodic:
                    pend = lag.flush()  # step i's loss goes into the saved sum
                    if pend is not None:
                        drain_metrics(pend)
                    if cfg.save is not None:
                        step_path = os.path.join(cfg.save, f"checkpoint_{epoch}_step_{i}")
                        os.makedirs(cfg.save, exist_ok=True)
                        save_checkpoint(
                            step_path, state,
                            CurriculumCursor(epoch, cur_guidance, cur_str_times, cur_guidance_id),
                            async_save=True,
                            mid=StepCursor(i, data_pass, batch_in_pass, id_flyp_loss_sum,
                                           -1.0 if cur_proportion is None else float(cur_proportion)),
                            host=_host_blob(last_perform, explore_rng, loss_pairs, progress_ma),
                        )
                        if primary:
                            logger.info("Saving step checkpoint to " + step_path)
                            # save_checkpoint waited for the previous commit, so
                            # the newest step checkpoint on disk is committed.
                            _prune_step_checkpoints(cfg.save, keep=2)
                        model_path = step_path
                if hit_budget:
                    logger.info(f"max_steps={cfg.max_steps} reached at epoch {epoch} step {i}; exiting")
                    _saves_committed()
                    return model_path

                if cfg.ma_progress and (num_batches - i) % 100 == 0:
                    logger.info(f"Running progress evaluation for moving average with i={i}")
                    _, _, _, cur_stats = progress_eval(cfg, whole_model(), last_perform, epoch, logger)
                    for g, value in cur_stats.items():
                        progress_ma.setdefault(g, []).append(value)

            prev = lag.flush()
            if prev is not None:
                drain_metrics(prev)

            id_flyp_loss_avg = id_flyp_loss_sum / max(num_batches, 1)

            if cfg.save is not None and not cfg.ma_progress:
                model_path = os.path.join(cfg.save, f"checkpoint_{epoch}")
                os.makedirs(cfg.save, exist_ok=True)
                # Committed in the background while the evaluation runs.
                save_checkpoint(
                    model_path, state, CurriculumCursor(epoch, cur_guidance, cur_str_times, cur_guidance_id),
                    async_save=True, host=_host_blob(last_perform, explore_rng, loss_pairs, progress_ma),
                )
                if primary:
                    logger.info("Saving model to " + str(model_path))
                    _prune_step_checkpoints(cfg.save, keep=1)

            if cfg.progress_train:
                logger.info("Progress evaluation on training data ...")
                dict_best_guid = progress_eval_train(cfg, whole_model(), epoch, logger, progress_ma)
                dict_best_guid["Epoch"] = epoch
                if primary:
                    with open(os.path.join(log_dir, f"best_guid{epoch}.pkl"), "wb") as f:
                        pickle.dump(dict_best_guid, f)
                if cfg.cluster == "loss" and primary:
                    from flyp_tpu_torch.training.kmeans import kmeans

                    labels, _, _ = kmeans([p[-1] for p in loss_pairs], n_clusters=7, seed=0, n_init=10)
                    new_pairs = [[p[0], p[1], int(label)] for p, label in zip(loss_pairs, labels)]
                    with open(os.path.join(log_dir, f"group_guid{epoch}.pkl"), "wb") as f:
                        pickle.dump(new_pairs, f)
                _saves_committed()
                return model_path  # the reference exits here

            if cfg.progress_eval:
                logger.info("Progress evaluation ...")
                _, str_progress, last_perform, _ = progress_eval(cfg, whole_model(), last_perform, epoch, logger,
                                                                 progress_ma)
                str_progress["Epoch"] = epoch
                if primary:
                    _write_tsv(os.path.join(log_dir, f"progress{epoch}.tsv"), list(str_progress),
                               [{0: v} for v in str_progress.values()], [0])
                    with open(os.path.join(log_dir, f"progress{epoch}.pkl"), "wb") as f:
                        pickle.dump([last_perform, progress_ma], f)

            if cfg.eval_datasets:
                logger.info("Formal evaluation ...")
                head = build_zeroshot_head(cfg, whole_model())
                clf = Classifier(model, head, batch_size=cfg.batch_size)
                evaluate(clf, cfg, epoch_stats, logger)
            else:
                # Contrastive pretraining (tar shards) has no class list for a head.
                logger.info("No eval datasets; skipping zero-shot evaluation")

            ood_acc = _avg_ood_acc(epoch_stats)
            if cfg.eval_datasets and primary:
                _write_class_stats(epoch_stats, cfg.eval_datasets, log_dir, epoch)

            epoch_stats["Avg OOD Acc"] = round(ood_acc, 4)
            logger.info(f"Avg OOD Acc : {ood_acc:.4f}")
            logger.info(f"Avg ID FLYP Loss : {id_flyp_loss_avg:.4f}")
            epoch_stats["Avg ID FLYP Loss"] = round(id_flyp_loss_avg, 4)
            epoch_stats = {k: v for k, v in epoch_stats.items() if " Class" not in k}
            stats.append(epoch_stats)
            if primary:
                _write_tsv(os.path.join(log_dir, "stats.tsv"), range(len(stats)), stats)
            sink.log(epoch_stats)

    finally:
        # The trace and the metrics file are closed on every exit path, the
        # raising ones included.
        prof.close()
        sink.close()
    _saves_committed()
    return model_path
