"""Entry points: a one-card forward check and a multi-rank dry run.

Counterpart of the JAX package's root ``__graft_entry__.py``.

``entry(device)`` returns ``(fn, args)``: ``fn(*args)`` is the flagship
ViT-B/16's forward in eval mode (the JAX entry's ``train=False``, so every
block of both towers runs the attention-block inference kernel) plus the
global-batch contrastive loss, averaged over a batch of 8 at 224 px and 77
tokens; bf16 on the card, fp32 on the CPU.

``dryrun_multichip(n, device)`` runs the JAX dry run's eight checks of one
training epoch's cycle over ``n`` ranks of ``torch.distributed``, through
the port's parallel layer: a TP x DP train step, the zero-shot head rebuilt
through the real tokenizer and template registry, a batch-sharded
evaluation through the head, a mid-curriculum checkpoint save -> restore ->
resume, FSDP with bf16 moments, a replica x data mesh, the fused
attention-block kernels under head-group TP against the plain route (the
loss, which the forward kernel computes, and the global gradient norm,
which the backward kernel feeds), and the GradCache step against the
direct step's loss.  On the CPU
the ranks are ``gloo`` processes; on the card they are ``nccl`` ranks, one
a card, where ``n`` cards are visible, else ``gloo`` ranks sharing the
card.

    python -m flyp_tpu_torch.entry            # entry() and dryrun_multichip(4) on the card
    python -m flyp_tpu_torch.entry --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import socket
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

MODEL = "ViT-B/16"
ENTRY_BATCH = 8
DRYRUN_RANKS = 4  # the ranks of ``python -m flyp_tpu_torch.entry``: one card's gloo ranks, or four cards
_LOSS_TOL = 1e-3  # steps 7 and 8 against step 1's loss, as in JAX
_GRAD_NORM_RTOL = 1e-3  # step 7's gradient norm against step 1's, relative


def _tiny_config(real_text: bool = False):
    """The flagship's config at test size: 64 px, two layers of width 128
    in each tower.  ``real_text`` keeps the real vocabulary and context so
    the zero-shot head runs through the real BPE tokenizer."""
    from flyp_tpu_torch.models.configs import MODEL_CONFIGS

    cfg = MODEL_CONFIGS[MODEL]
    if real_text:
        text = dataclasses.replace(cfg.text, width=128, heads=2, layers=2)
    else:
        text = dataclasses.replace(cfg.text, context_length=32, vocab_size=1024, width=128, heads=2, layers=2)
    return dataclasses.replace(
        cfg,
        embed_dim=64,
        vision=dataclasses.replace(cfg.vision, image_size=64, patch_size=16, width=128, layers=2, heads=2),
        text=text,
    )


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` is the mean contrastive loss of the
    randomly initialised ViT-B/16 on a seeded batch, in eval mode."""
    from flyp_tpu_torch.models.factory import build_clip_model, resolve_device
    from flyp_tpu_torch.models.modes import pinned_mode
    from flyp_tpu_torch.ops.losses import clip_loss

    device = resolve_device(device)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    model = build_clip_model(SimpleNamespace(model=MODEL, clip_load=None, compute_dtype=dtype, seed=0),
                             device=device)
    config = model.config
    px, ctx = config.vision.image_size, config.text.context_length

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((ENTRY_BATCH, px, px, 3))).to(device, model.compute_dtype)
    tokens = np.zeros((ENTRY_BATCH, ctx), dtype=np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:5] = rng.integers(1, 49000, (ENTRY_BATCH, 4))
    tokens[:, 5] = 49407
    tokens = torch.from_numpy(tokens).to(device)

    def fn(model, images, tokens):
        with torch.inference_mode(), pinned_mode(model, train=False):
            img_f, txt_f, scale = model(images, tokens)
            return clip_loss(img_f, txt_f, scale).mean()

    return fn, (model, images, tokens)


# ---------------------------------------------------------------------------
# The multi-rank dry run.


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _attention_route(impl: str):
    """``FLYP_ATTENTION_IMPL=impl`` for the body; the caller's choice after."""
    from flyp_tpu_torch.ops import attention as dispatch

    prev = os.environ.get(dispatch._IMPL_ENV)
    os.environ[dispatch._IMPL_ENV] = impl
    dispatch._default_impl.cache_clear()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(dispatch._IMPL_ENV, None)
        else:
            os.environ[dispatch._IMPL_ENV] = prev
        dispatch._default_impl.cache_clear()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _dryrun_body(n: int, device: torch.device, tmp: str) -> dict:
    """The eight checks on this rank; every rank runs them, in one group."""
    import torch.distributed as dist

    from flyp_tpu_torch.evaluation.zeroshot import get_zeroshot_classifier
    from flyp_tpu_torch.models.clip import CLIPModel
    from flyp_tpu_torch.models.modes import pinned_mode
    from flyp_tpu_torch.ops import attention_block as ab
    from flyp_tpu_torch.parallel import comm
    from flyp_tpu_torch.parallel.fsdp import shard_train_state_fsdp
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, shard_batch
    from flyp_tpu_torch.parallel.tp import shard_train_state
    from flyp_tpu_torch.templates import get_template
    from flyp_tpu_torch.tokenizer import tokenize
    from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr
    from flyp_tpu_torch.utils.checkpoint import CurriculumCursor, restore_checkpoint, save_checkpoint

    model_axis = 2 if n % 2 == 0 and n > 2 else 1
    data_axis = n // model_axis
    mesh = create_mesh(MeshConfig(data=data_axis, model=model_axis))
    config = _tiny_config(real_text=True)
    initial = CLIPModel(config).init_parameters(0).state_dict()

    def fresh(state_dict=initial):
        model = CLIPModel(config)
        model.load_state_dict(state_dict, strict=True)
        return model.to(device)

    optimizer = make_optimizer(warmup_cosine_lr(1e-5, 10, 100), weight_decay=0.1)

    batch = 2 * data_axis
    rng = np.random.default_rng(0)
    images = rng.standard_normal((batch, config.vision.image_size, config.vision.image_size, 3)).astype(np.float32)
    classnames = ["cat", "dog"]
    labels = np.arange(batch) % len(classnames)
    tokens = tokenize([f"a photo of a {classnames[l]}." for l in labels])

    def rows(m):  # this rank's rows of the global batch on mesh m
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in shard_batch(m, (images, tokens))]

    def step(state, m, opt=optimizer, **kw):  # (state, the step's scalar metrics)
        state, metrics = make_train_step(state.model, opt, mesh=m, **kw)(state, *rows(m))
        return state, {k: float(v) for k, v in metrics.items() if v.ndim == 0}

    out, seconds = {"mesh": dict(mesh.shape)}, {}
    t0 = time.perf_counter()

    # 1. One TP x DP train step on batch-sharded (image, caption) pairs.
    state, metrics = step(shard_train_state(mesh, create_train_state(fresh(), optimizer)), mesh, log_grad_norm=True)
    loss = metrics["loss"]
    _check(np.isfinite(loss) and np.isfinite(metrics["grad_norm"]), f"non-finite step {metrics}")
    _check(state.step == 1, f"step {state.step} after one step")
    out["loss"], out["grad_norm"] = loss, metrics["grad_norm"]
    seconds["tp_dp_step"] = time.perf_counter() - t0

    # 2. The zero-shot head rebuilt from the updated text tower.
    t0 = time.perf_counter()
    head = get_zeroshot_classifier(state.model, classnames, get_template("simple_template"), encode_batch=8)
    _check(tuple(head.weight.shape) == (len(classnames), config.embed_dim), f"head {tuple(head.weight.shape)}")
    out["head"] = list(head.weight.shape)
    seconds["head"] = time.perf_counter() - t0

    # 3. The batch-sharded evaluation through the head.
    t0 = time.perf_counter()
    with torch.no_grad(), pinned_mode(state.model, train=False):
        local = head(state.model.encode_image(rows(mesh)[0]))
    logits = comm.all_gather(local, mesh.group("data"), dim=0).float().cpu().numpy()
    _check(logits.shape == (batch, len(classnames)) and np.isfinite(logits).all(), f"eval logits {logits.shape}")
    out["eval_top1"] = float(np.mean(logits.argmax(-1) == labels))  # random init: the plumbing is the test
    seconds["eval"] = time.perf_counter() - t0

    # 4. A mid-curriculum checkpoint: save -> restore into fresh weights -> resume.
    t0 = time.perf_counter()
    cursor = CurriculumCursor(epoch=1, cur_guidance=30, cur_str_times=2, cur_guidance_id=3)
    ckpt = os.path.join(tmp, "ckpt")
    save_checkpoint(ckpt, state, cursor)
    dist.barrier()  # rank 0 writes; every rank reads
    other = CLIPModel(config).init_parameters(1).state_dict()
    restored = shard_train_state(mesh, create_train_state(fresh(other), optimizer))
    restored, r_cursor = restore_checkpoint(ckpt, restored)
    _check(r_cursor == cursor, f"cursor round trip {r_cursor} != {cursor}")
    restored, resumed = step(restored, mesh)
    resumed = resumed["loss"]
    _check(restored.step == 2, f"the resumed run is at step {restored.step}, not 2")
    _check(np.isfinite(resumed), f"non-finite resumed loss {resumed}")
    out["resumed_loss"] = resumed
    del state, restored, head
    seconds["checkpoint"] = time.perf_counter() - t0

    # 5. FSDP over every rank with bf16 Adam moments.
    t0 = time.perf_counter()
    bf16_opt = make_optimizer(warmup_cosine_lr(1e-5, 10, 100), weight_decay=0.1, moment_dtype="bfloat16")
    fsdp_mesh = create_mesh(MeshConfig(data=n, model=1))
    out["fsdp_loss"] = step(shard_train_state_fsdp(fsdp_mesh, create_train_state(fresh(), bf16_opt)),
                            fsdp_mesh, bf16_opt)[1]["loss"]
    _check(np.isfinite(out["fsdp_loss"]), f"non-finite FSDP loss {out['fsdp_loss']}")
    seconds["fsdp"] = time.perf_counter() - t0

    # 6. A replica x data mesh: the InfoNCE gather spans both batch axes.
    if n % 2 == 0 and n >= 4:
        t0 = time.perf_counter()
        ms_mesh = create_mesh(MeshConfig(data=n // 2, model=1, replica=2))
        ms_state = create_train_state(fresh(), optimizer)
        ms_state.mesh = ms_mesh
        out["replica_loss"] = step(ms_state, ms_mesh)[1]["loss"]
        _check(np.isfinite(out["replica_loss"]), f"non-finite replica x data loss {out['replica_loss']}")
        seconds["replica"] = time.perf_counter() - t0

    # 7. The fused attention-block kernels (B1/B2, per head shard) under TP,
    # against step 1 from the same weights: the loss (B1's forward) and the
    # global gradient norm (B2's gradients flow into every parameter's).
    if model_axis > 1:
        t0 = time.perf_counter()
        before = (ab.attention_block.fwd_launches, ab.attention_block.bwd_launches)
        with _attention_route("pallas_block"):
            metrics = step(shard_train_state(mesh, create_train_state(fresh(), optimizer)), mesh,
                           log_grad_norm=True)[1]
        out["pallas_block_loss"], out["pallas_block_grad_norm"] = metrics["loss"], metrics["grad_norm"]
        out["pallas_block_launches"] = {"B1": ab.attention_block.fwd_launches - before[0],
                                        "B2": ab.attention_block.bwd_launches - before[1]}
        _check(abs(out["pallas_block_loss"] - loss) < _LOSS_TOL,
               f"pallas_block TP loss {out['pallas_block_loss']} != xla {loss}")
        _check(abs(metrics["grad_norm"] - out["grad_norm"]) <= _GRAD_NORM_RTOL * out["grad_norm"],
               f"pallas_block TP gradient norm {metrics['grad_norm']} != xla {out['grad_norm']}")
        seconds["pallas_block"] = time.perf_counter() - t0

    # 8. The GradCache step (2 chunks) on the TP x DP mesh, against step 1.
    t0 = time.perf_counter()
    out["grad_cache_loss"] = step(shard_train_state(mesh, create_train_state(fresh(), optimizer)), mesh,
                                  grad_cache_chunks=2)[1]["loss"]
    _check(abs(out["grad_cache_loss"] - loss) < _LOSS_TOL, f"grad-cache loss {out['grad_cache_loss']} != {loss}")
    seconds["grad_cache"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def _dryrun_rank(rank: int, n: int, backend: str, device_type: str, port: int, tmp: str) -> None:
    """One rank of the dry run (a spawned process); rank 0 writes the result."""
    import torch.distributed as dist

    if device_type == "cuda":
        device = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=600), **kw)
    try:
        # The plain route for every step but 7: on the card the default is
        # the fused block, and step 7 must compare the kernels with it.
        with _attention_route("xla"):
            out = _dryrun_body(n, device, tmp)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run over ``n_devices`` ranks (module docstring); raises
    if a check fails, else prints one line and returns rank 0's numbers."""
    import torch.multiprocessing as mp

    from flyp_tpu_torch.models.factory import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        backend = "nccl" if torch.cuda.device_count() >= n_devices else "gloo"
    else:
        backend = "gloo"
    shared = device.type == "cuda" and backend == "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_rank, args=(n_devices, backend, device.type, _free_port(), tmp),
                           nprocs=n_devices, join=True, start_method="spawn")
        with open(os.path.join(tmp, "result.json")) as f:
            out = json.load(f)
    out.update(backend=backend, shared_card=shared, seconds_total=time.perf_counter() - t0)
    where = f"{backend} ranks on {device.type}" + (", all sharing one card" if shared else "")
    print(f"dryrun_multichip({n_devices}): {where}, mesh={out['mesh']}, loss={out['loss']:.4f}, "
          f"resumed loss={out['resumed_loss']:.4f}, fsdp loss={out['fsdp_loss']:.4f}, "
          f"grad-cache loss={out['grad_cache_loss']:.4f}, head={tuple(out['head'])} OK", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain path)")
    args = p.parse_args(argv)
    fn, fn_args = entry(args.device)
    print("entry loss:", float(fn(*fn_args)), flush=True)
    dryrun_multichip(DRYRUN_RANKS, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
