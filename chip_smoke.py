#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``flyp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --digests            # only the B1-B6 and T1 output digests
    python3 chip_smoke.py --attention-times    # only the attention kernels' device ms
    python3 chip_smoke.py --gemm               # only the five products of gemm_sm90.cuh (G1-G5)
    python3 chip_smoke.py --input              # only the input pipeline (phase 5b) and a synthetic bench
    python3 chip_smoke.py --eval               # only the evaluation harness (phase 9)
    python3 chip_smoke.py --trainer            # only the FLYP trainer (phase 10)
    python3 chip_smoke.py --resnet             # only the RN50 towers and the chunked step (phase 11)
    python3 chip_smoke.py --parallel           # only the head-shard kernels and the trainer across ranks (phase 12)
    python3 chip_smoke.py --parallel-trainer   # only phase 12's trainer across ranks (nccl on every card)
    python3 chip_smoke.py --research           # only the research trainers (phase 13)
    python3 chip_smoke.py --surface            # only HTTP serving, entry points and tools (phase 14)
    python3 chip_smoke.py --measure            # only the measurement and check tools, ViT-L/14 (phase 15)

Phases, each of which raises on failure:

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build every CUDA kernel of the package from ``flyp_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once;
3. the five bf16 products of ``csrc/gemm_sm90.cuh`` that B1-B3 run (G1-G5,
   ``ops/gemm_sm90.py``) alone, at the vision (M = 256 x 197, D = 768) and
   text (M = 256 x 32 and 64 x 77, D = 512) shapes, each over a poisoned
   output against its plain version, two launches bit-equal, timed beside
   ``torch.mm`` and the card's bound, untileable shapes refused; then
   each kernel against its plain PyTorch version at its path's shapes (B=64
   in fp32 (TF32 off) and bf16, the main paths' batch 256 in bf16, and
   ViT-L/14's L = 257 and 577 at D = 1024 for B1-B3),
   timed with CUDA events beside the plain
   version, a composite PyTorch yardstick and the card's bound: the
   inference forward (B3), the training forward (B1) on all it returns,
   and the training backward (B2) against the plain backward and against
   autograd through the plain forward; at the vision length (L=197) also
   each block's attention step alone (the device time of its attention
   kernels under torch.profiler) beside ``F.scaled_dot_product_attention``;
4. the serving slice at full ViT-B/16 width in bf16: ``ClipServer.
   from_checkpoint`` on a random-init ``.pt`` written by the port's own
   converter, a zero-shot head, warmup, classify / top_k / encode_texts /
   stream_logits requests with B3's launch count checked exactly, features
   held against the CPU plain forward, and img/s at buckets 64 and 256;
5. the training slice at full ViT-B/16 width: one fp32 step's loss and
   gradients on the card against the CPU plain step (and bf16 against the
   same), the bench configuration (batch 256, bf16, bf16 Adam moments)
   timed over 10 steps with B1/B2/B3 launches checked exactly, a learning
   check, the epoch's end (zero-shot head rebuilt from the trained text
   tower, ``Classifier`` top-1) and a profile of one step;
5b. the training input pipeline, on the same route: a seeded corpus on disk
   (512 PNG and ``.npy`` sources of 256-512 px, the committed JPEG
   fixtures, 14 batches of 256 caption rows, three tar shards) read through
   ``parse_arguments`` -> ``training/data.py::train_loader`` (native
   decode and transform, ``--workers 6``) -> ``device_iter`` (bf16 host
   cast, the pinned ring, a copy stream); the loader's img/s at 6 workers
   and at every core, native ms per image, collate/cast/H2D ms per batch;
   every batch of an epoch through the ring bit-equal to an independent
   host pass (twice: from the live loader and from host batches in memory,
   the consumer running matmuls between batches), the mid-epoch
   fast-forward's batch equal; 13 full-width steps fed from disk beside the
   synthetic rate, B1/B2 launches exact, and one profiled fed step; 2 steps
   fed from the tar shards with the sample accounting exact;
6. the MLP block (B4), fused-QKV attention (B5, forward and backward) and
   whole-row attention (B6, forward and backward) against their plain
   versions (B=64 in fp32 and bf16 at vision L=197 and text L=77, the
   training main path's batch 256 in bf16 at L=197 and L=32, B5/B6 at
   L=577 and L=1024, B4 at ViT-L/14's D=1024, L=257), timed beside the
   plain version, the card's bound and ``F.scaled_dot_product_attention``
   (B5/B6) or a composite (B4); B5/B6's outputs are held to
   ``flyp_tpu_torch.testing.check_attention``, which planted faults must
   fail at every shape (the backward without ``delta``; in bf16 also the
   forward that casts ``p`` before normalising it and the backward whose
   ``delta`` is ``rowsum(do T(o))``); B4's over NaN-poisoned outputs with a
   guard past each end, a second launch bit-equal, and in bf16 its
   hidden activations held to ``check_mlp_hidden``, which the planted fault
   (``h`` of the unrounded sum) must fail; B4's four bf16 launches timed one
   by one at the vision shape beside ``torch.mm``;
7. the other ``FLYP_ATTENTION_IMPL`` routes (``pallas_qkv``, ``pallas``,
   ``pallas_block_mlp``, ``xla``; the default ``pallas_block`` is phases 4
   and 5): one fp32 step against the CPU plain step under the same route
   (all but ``xla``), 13 steps of the bench configuration and a 256-image
   ``classify`` with every kernel's launches checked exactly (a route
   launches its own kernels and no other), train and serve img/s, and the
   device ms of one vision block's attention and MLP sub-blocks (also
   measured for the default route in phase 5).

8. the measurement probes: T1 (the probe GEMM, bf16 into fp32 and int8
   into int32), T2 (the per-head score sum, hd 64/128/256, at L = 208 and
   the odd 197, 257 and 577), T3 (the row-count GEMM, R 197/200/208/256) and T4 (the
   fused AdamW update, fp32 and bf16 moments) against their plain versions
   at the tools' shapes (T1 also at ``tests/test_tools.py``'s shapes and
   three ragged M; T1-T3's outputs poisoned before each launch, with a
   guard region past the end that must stay untouched, and a second launch
   bit-equal to the first; shapes T1 cannot tile must raise), timed
   beside the plain version, a library call and the card's bound; then the
   ported tools end to end (``int8_matmul_probe`` ``main``/``main_pallas``
   at batch 256, every ``mfu_levers`` probe, the head rebuild at 100
   classes), each kernel's launches counted exactly.
9. the evaluation harness at full width in bf16: a seeded corpus on disk
   (PNGs of 256-400 px: ImageNet's val tree at 2 images a class,
   ImageNet-R's 200 folders, ObjectNet's 113 with their red border, and
   iWildCam's and FMoW's metadata with rows that must be left out), then
   ``cli/zeroshot_eval.main`` three times as a user runs it (batch 256,
   ``--workers 6``): the ImageNet head of 1,000 classes x 80 templates over
   ImageNet, ImageNet-R and ObjectNet; iWildCam's head over IWildCamOOD;
   FMoW's over FMOWOOD.  B3's launches exact (every text block per prompt
   chunk, every vision block per batch); every ``train_stats`` entry equal
   to a numpy recomputation from the logits the harness saw and the labels
   the corpus was written with; 64 images' features against the CPU plain
   forward (cosine 0.9999 fp32, 0.99 bf16); the head's first 10 classes
   against the CPU plain head; ``get_features`` twice, the cache hit
   launching nothing; eval img/s through the loader beside device-only
   img/s of the same batches.
10. the FLYP trainer at full ViT-B/16 width in bf16 with bf16 moments, batch
   256, through ``cli/main.py`` as a user runs it: the input phase's corpus
   (14 batches, guidance 100 and 50, ``--curriculum``, ``--data_backend
   native``, ``--workers 6``) and phase 9's ImageNet val tree (2,000 PNGs,
   ``--eval-datasets ImageNet`` with the 80-template head).  Run A trains 2
   epochs (train, checkpoint, head, evaluation, ``stats.tsv``); run B is
   the same command stopped by ``--max_steps 7 --save_every_n_steps 5``,
   then ``--max_steps 10``, then resumed to the end.  Held exactly: A's and
   B's ``checkpoint_0`` and ``checkpoint_1`` bit-equal (params, moments,
   meta), their ``stats.tsv`` equal, B1/B2/B3 launches as predicted (24
   blocks x 28 steps for B1/B2; 79 text chunks x 12 + 8 batches x 12 a
   epoch for B3); ``checkpoint_1`` reloaded through ``cli/zeroshot_eval``
   gives the trainer's logged top-1, and its ``--save``'d head reads back
   bit-equal; 13 synthetic steps with ``--remat`` give the losses and
   parameters of 13 without it, at a lower peak.  Seconds per epoch
   (train, the save's blocking part, its background commit, head,
   evaluation), fed img/s and peak memory go to a ``"trainer"`` line.
11. the ModifiedResNet towers and the chunked (GradCache) step on the
   default route: RN50 at full width (one fp32 step's loss, gradients and
   updated running statistics on the card against the CPU plain step, and
   bf16 against the same; 13 steps of the bench configuration with B1 = B2
   = 12 a step exactly and no B3, the statistics moving, a learning check);
   the chunked RN50 step (256 = 2 x 128, bf16) against the chunk-wise oracle
   on the card (loss, gradients, the statistics chained over both chunks);
   the chunked ViT-B/16 step at 512 = 4 x 128 against the direct step at
   512 (loss, per-tensor gradient cosines, launches B1 = 24 x 2 x 4 and B2
   = 24 x 4 a step against 24 and 24, ms a step and peak memory); the RN50
   trainer through ``cli/main.py`` with ``--grad_cache_chunks 2`` on the
   input phase's corpus and phase 9's ImageNet val tree, the same command
   stopped by ``--max_steps 5 --save_every_n_steps 3`` and resumed,
   ``checkpoint_0`` bit-equal (params, moments, ``batch_stats.pt``, meta),
   launches exact, the checkpoint reloaded through ``cli/zeroshot_eval`` to
   the logged top-1; ``ClipServer.from_checkpoint`` on an RN50 ``.pt`` with
   moved running statistics (a 256-image ``classify``, B3 exact, features
   against the CPU plain forward).  Its numbers go to a ``"resnet"`` line.

12. parallelism across ranks at full ViT-B/16 width in bf16: B3, B1 and B2
   on head shards (``partial`` / ``add_g=False``; Dv = D / n at n = 2 and
   4 for ViT-B/16 and ViT-L/14, fp32 and bf16) against their plain
   versions, and the sum over the n shard launches (plus ``x + bout``, or
   ``g``) against the unsharded kernel, timed beside both (Dv = 192, 3
   heads, among them: the GEMMs' 64-column tiles); G1-G5 at Dv = 192 and
   320 against their plain versions, the exact product and (G3)
   ``torch.mm``; that this torch build's gloo takes CUDA tensors for every
   collective the port calls; a full-width ViT-B/16 vision block (B = 256,
   bf16) tensor-parallel over 2 gloo ranks of the card on ``pallas_qkv``,
   ``pallas`` and ``pallas_block_mlp`` and over 4 on ``pallas_block`` (Dv =
   192), its output and every gradient against the same block whole, each
   rank's launches exact; then ``cli/main.py`` trained for 4 steps at batch 256 from the seed-0
   weights at a learning rate of 1e-4 with no warm-up: once as one process
   under torchrun over ``nccl`` (world 1), then across ranks with data
   parallelism, tensor parallelism (``--mesh_model 2``) and FSDP, over
   ``nccl`` with one rank a card (world = min(cards, 4)) or, on one card,
   as 2 ranks over ``gloo``; each run's per-step losses and global gradient
   norms and its final parameters (the checkpoint, as a share of the one-
   process run's own movement) against the one-process run's, every rank's
   B1/B2 launches exact (one a block a step), each checkpoint holding the
   whole model's shapes, an FSDP run stopped after 2 steps and resumed
   ending bit-equal to the uninterrupted one, and a planted fault (a data-
   parallel run whose gradient sum is skipped) failing each of the three
   bounds; and RN50 the same way, directly and with ``--grad_cache_chunks
   2``, in one process and data-parallel, its running statistics bit-equal
   on every rank and near the one-process run's, with a planted fault
   (BatchNorm on each rank's own rows) failing a check.  Phases 10 and 11's
   trainers and phase 12's ViT-B/16 trainer runs run at 4 ViT layers a
   tower and an RN50 of one bottleneck a stage (full width; TRAINER_DEPTH,
   RN_TRAINER_DEPTH).  Its numbers go to a ``"parallel"`` line.
13. the research trainers at full ViT-B/16 width, on a PatchCamelyon-shaped
   tree the phase writes (two classes of 96-px PNGs in train, val, test and
   train_shot_16; a guidance TSV at guidance 50 and 100): (a) few-shot
   through ``cli/few_shot.py``, k = 16 (a batch of 32), 4 epochs, full
   depth, the kept snapshot's scores reproducing on the card and B1/B2/B3
   launches exact; (b) the CE ablation: its first step's loss and
   gradients at B = 4 (B3 forward, B1 + B2 backward) against the CPU plain
   step (cosine 0.9999 fp32, 0.99 bf16), its step's ms at batch 32, one
   epoch through ``cli/main.py --ce_ablation`` with exact launches, and 2
   gloo ranks at ``TRAINER_DEPTH`` against one process (per-step losses at
   phase 12's bound); (c) the Fisher step, fp32, on 16 ViT-B/16 images
   (B3, B1 and B2 at batch 1) and 8 RN50 images at ``RN_TRAINER_DEPTH``,
   against the CPU port's on the same images and labels, a planted fault
   (the square of the batch-summed gradient) failing the bound, ms an
   example; (d) the linear probe: features through B3, the C sweep on the
   card in float32 giving the best i, C and accuracy of the same sweep on
   the CPU in float64; (e) the progress-validation beam search (beam 2, one
   round, ``TRAINER_DEPTH``): each kept snapshot, restored, holding its
   candidate's state bit for bit and giving its ``progress_eval`` again.
   Seconds for each part; its numbers go to a ``"research"`` line.
14. HTTP serving, the entry points and the tools: (a) ``serving/http.py``
   bound on an ephemeral port over phase 4's full-width ViT-B/16 bf16
   server (in the whole run, before phase 4 drops it): ``/healthz``, then
   ``/features`` and ``/classify?k=3`` at 5 and 64 images and
   ``/text_features``, each answer bit-equal to the direct ``ClipServer``
   call and B3's launches exact; 8 of those requests again on 4 threads at
   once, bit-equal and exact; ms a request beside the direct call; (b)
   ``entry.entry()`` (ViT-B/16, bf16, batch 8): B3 once a block (24), a
   finite loss within bf16 rounding of the plain route's, and the image
   and text features it computes against the plain route's on the same
   model and batch (least row cosine 0.99, as phase 4's bf16 bound); (c)
   ``entry.dryrun_multichip(4)``: the eight checks on 4 ranks (``gloo``
   ranks sharing the card where fewer than 4 cards are visible), B1 and B2
   once a block of the tiny model in its kernel step, whose loss and
   gradient norm the dry run holds to the plain step's; (d)
   ``tools/validate_data.py`` and ``tools/validate_checkpoint.py`` (a
   full-width ``.pt``, ``--template simple_template``, B3 exact) on an
   ImageNet val tree of one PNG a class, its ``activation_crosscheck`` on
   the card (fp32, B3 once a block) against a stand-in reference that runs
   the port's plain model on the CPU (features within 1e-3 of their
   largest entry), and the datacreation tools that need no h5py on small
   trees.  Its numbers go to a ``"surface"`` line.
15. the measurement and check tools of ``flyp_tpu_torch/tools/`` on the
   default route: (a) ViT-L/14 at full width in bf16 (vision rows of 257
   keys: B1-B3's long-row route): at the recipe's batch 256 with
   ``--remat``, one step's loss and gradients against the plain route on
   the card (loss 2e-2, least gradient cosine 0.99, phase 5's bf16
   bounds), then the direct step timed (it must fit), its MFU
   (``utils/profiling.py``), peak memory and a profiled step (B2's share);
   ``grad_cache_bench`` at 512 = 8 x 64 (the direct attempt, where running
   out of memory is "does not fit", then the chunked run after the memory
   is released); ``serving_bench`` at 8 and 256 and ViT-L/14@336px (L =
   577) at 64, each size's features against the plain route's (least row
   cosine 0.99, phase 4's bf16 bound); B1/B2/B3 launches exact in each;
   (b) ``kernel_breakdown`` at ViT-L/14 and ViT-B/32 (batch 256, launches
   exact) and ``rn50_breakdown`` at 256 (per stage: ms, GFLOP, share of
   peak); (c) ``convergence_check`` (120 steps of the tiny CLIP in bf16 on
   the default route, held to the plain route's trajectory), ``bf16_drift``
   (60 steps), ``loop_sync_ab``, ``eval_sync_ab``, ``host_decode_bench``
   and ``e2e_check`` (ViT-B/16 at ``TRAINER_DEPTH``, one epoch through
   ``cli/main.py``).  Its numbers go to a ``"measure"`` line.

The products' numbers are a JSON line of their own (``"gemm"``), the input
pipeline's, the evaluation's, the trainer's and phases 11-15's too (``"input"``,
``"evaluation"``, ``"trainer"``, ``"resnet"``, ``"parallel"``, ``"research"``,
``"surface"``, ``"measure"``); the line
before the last is a JSON object of per-kernel numbers; the last
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flyp_tpu_torch.evaluation import Classifier, get_zeroshot_classifier, topk_accuracy  # noqa: E402
from flyp_tpu_torch.models import MODEL_CONFIGS, build_clip_model, convert  # noqa: E402
from flyp_tpu_torch.ops import _kernels  # noqa: E402
from flyp_tpu_torch.ops import attention as attention_dispatch  # noqa: E402
from flyp_tpu_torch.ops import attention_block as ab  # noqa: E402
from flyp_tpu_torch.ops import flash_attention as fa  # noqa: E402
from flyp_tpu_torch.ops import fused_qkv_attention as fq  # noqa: E402
from flyp_tpu_torch.ops import gemm_sm90 as gs  # noqa: E402
from flyp_tpu_torch.ops import mlp_block as mb  # noqa: E402
from flyp_tpu_torch.ops.losses import clip_loss  # noqa: E402
from flyp_tpu_torch.serving import ClipServer  # noqa: E402
from flyp_tpu_torch.templates import simple_template  # noqa: E402
from flyp_tpu_torch.testing import check_gemm, check_gemm_product, check_rounded_product  # noqa: E402
from flyp_tpu_torch.testing import reference_stand_in  # noqa: E402
from flyp_tpu_torch.tokenizer import shrink_context  # noqa: E402
from flyp_tpu_torch.tools import int8_matmul_probe as tip  # noqa: E402
from flyp_tpu_torch.tools import mfu_levers as tml  # noqa: E402
from flyp_tpu_torch.tools._bench import bench_batch  # noqa: E402
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr  # noqa: E402
from flyp_tpu_torch.utils.profiling import card_peaks, clip_flops, mfu, plain_route  # noqa: E402

MODEL = "ViT-B/16"
BUCKETS = (8, 64, 256)
CLASSNAMES = ["cat", "dog", "school bus", "golden retriever", "tench"]
# Kernel vs plain: fp32 sums in another order (1e-4); bf16 additionally
# may flip a rounding inside q/k/v/p/o, a few bf16 ulps of O(1) outputs.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_HEAD_DIM = 64
# B2 against its plain version: dx elementwise (bf16: a flipped rounding in
# do/ds/dq/dk/dv moves dx by a few ulps, so 5e-2), and the relative norm of
# the sums over every row (dWqkv, dbqkv, dscale, dbias).  Against autograd
# through the plain forward, which rounds nowhere in its backward: relative
# norm 1e-4 in fp32 (summation order) and 5e-2 in bf16 (the kernel's
# rounding points).
BWD_TOL = {torch.float32: (1e-4, 1e-5, 1e-4), torch.bfloat16: (5e-2, 1e-2, 5e-2)}
# B1's fp32 lse, absolute: against the plain lse of the kernel's own q and k
# (the same scores summed in another order) 1e-4; against the plain
# forward's lse, whose q or k may hold an element rounded to the
# neighbouring bf16 value (a score moved by up to ~1e-2), 1e-4 in fp32 and
# 1e-2 in bf16.
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_OWN_TOL = 1e-4
BOTH = (torch.float32, torch.bfloat16)
# (B, L, D, H, causal, dtypes).  The training main path runs B1 and B2 at
# batch 256 in bf16 on vision L=197 and on text L=32 (captions of 6-20
# tokens after shrink_context); the B=64 rows add fp32 and L=77, the B=8
# rows ViT-L/14 at 224 px (L=257) and 336 px (L=577), D=1024, and the last
# row ViT-H/14's vision tower at its training batch (heads of 80, bf16 only).
VIT_L_SHAPES = [(8, 257, 1024, 16, False, BOTH), (8, 577, 1024, 16, False, (torch.bfloat16,))]
VIT_H_SHAPES = [(256, 257, 1280, 16, False, (torch.bfloat16,))]
TRAIN_SHAPES = [(64, 197, 768, 12, False, BOTH), (64, 32, 512, 8, True, BOTH), (64, 77, 512, 8, True, BOTH),
                (256, 197, 768, 12, False, (torch.bfloat16,)), (256, 32, 512, 8, True, (torch.bfloat16,)),
                *VIT_L_SHAPES, *VIT_H_SHAPES]
# The serving main path runs B3 at buckets up to 256 images (vision L=197)
# and on text chunks (L=16 after shrink_context); the zero-shot probe of
# phase 8 on text chunks of 2048 and 1856 prompts (L=16).
INFER_SHAPES = [(64, 197, 768, 12, False, BOTH), (64, 16, 512, 8, True, BOTH), (64, 77, 512, 8, True, BOTH),
                (256, 197, 768, 12, False, (torch.bfloat16,)), (2048, 16, 512, 8, True, (torch.bfloat16,)),
                (1856, 16, 512, 8, True, (torch.bfloat16,)), *VIT_L_SHAPES, *VIT_H_SHAPES]
MAIN_SHAPE = (256, 197, "bfloat16")  # the kernels line reports each kernel at the main path's vision shape


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_bound_ms(B, L, D, causal, dtype, peaks):
    """(ms, "operations" | "bytes"): max(FLOPs / peak, bytes / bandwidth) for
    one attention-block call.  FLOPs: QKV + scores + p@v (half the L^2 work
    under the causal mask) + out-proj; bytes: x read and out written once,
    the four D x D matrices read once."""
    attn = 4 * B * L * L * D * (0.5 if causal else 1.0)
    flops = 2 * B * L * D * 3 * D + attn + 2 * B * L * D * D
    el = torch.finfo(dtype).bits // 8
    nbytes = 2 * B * L * D * el + 4 * D * D * el
    t_ops, t_bytes = flops / peaks[dtype], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def block_inputs(B, L, D, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=g)).cuda()

    return (
        r(B, L, D).to(dtype), r(D, scale=0.1, shift=1.0), r(D, scale=0.1),
        r(3, D, D, scale=D ** -0.5), r(3, D, scale=0.1), r(D, D, scale=D ** -0.5), r(D, scale=0.1),
    )


def yardstick(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal):
    """``F.layer_norm + F.linear + F.scaled_dot_product_attention +
    F.linear``: one library call per stage, timed only (the port never calls
    it).  No single PyTorch call computes the whole block, so the kernel
    line's ``library_ms`` is null and this time goes in ``composite_ms``."""
    F = torch.nn.functional
    B, L, D = x.shape
    dt = x.dtype
    y = F.layer_norm(x, (D,), ln_scale.to(dt), ln_bias.to(dt), 1e-5)
    qkv = F.linear(y, qkv_kernel.transpose(1, 2).reshape(3 * D, D).to(dt), qkv_bias.reshape(3 * D).to(dt))
    q, k, v = qkv.view(B, L, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=causal).transpose(1, 2).reshape(B, L, D)
    return x + F.linear(o, out_kernel.T.to(dt), out_bias.to(dt))


def kernel_ms(fn, pattern: str, calls: int = 10):
    """Device ms per call of ``fn`` spent in the kernels whose names match
    ``pattern``, from torch.profiler over ``calls`` calls after a warm-up
    (B3's, B1's or B2's attention step inside the block), or None when the
    trace shows no such device time (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and re.search(pattern, evt.key):
            dev = getattr(evt, "self_device_time_total", None)
            total += dev if dev is not None else getattr(evt, "self_cuda_time_total", 0)
    return total / 1e3 / calls if total > 0 else None


def attention_yardstick_ms(B, L, D, H, causal, dtype):
    """SDPA's (forward ms, autograd-backward ms) on random [B, L, H, 64] q,
    k, v of the block's attention step, the yardstick of B1-B3's step."""
    gen = torch.Generator().manual_seed(L + 5)
    q, k, v = (torch.randn(B, L, H, _HEAD_DIM, generator=gen).cuda().to(dtype) for _ in range(3))
    return sdpa_ms(q, k, v, torch.randn(B, L, D, generator=gen).cuda().to(dtype), causal)


# B1-B3's attention step is timed alone (kernel_ms) at the vision length.
STEP_L = 197


def phase_kernels(peaks) -> list:
    cases = []
    for B, L, D, H, causal, dtypes in INFER_SHAPES:
        for dtype in dtypes:
            before = head_dim_launches()
            args = block_inputs(B, L, D, dtype, seed=L)
            with torch.inference_mode():
                out = ab.attention_block_inference(*args, H, causal)
                torch.cuda.synchronize()
                ref = ab.attention_block_inference_reference(*args, H, causal)
                max_err = check_close("B3", out, ref, TOL[dtype], (B, L, D, H, causal, str(dtype)))
                ms = cuda_ms(lambda: ab.attention_block_inference(*args, H, causal))
                plain_ms = cuda_ms(lambda: ab.attention_block_inference_reference(*args, H, causal))
                composite_ms = cuda_ms(lambda: yardstick(*args, H, causal))
            bound_ms, bound_by = block_bound_ms(B, L, D, causal, dtype, peaks)
            case = dict(B=B, L=L, D=D, H=H, causal=causal, dtype=str(dtype).split(".")[-1],
                        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, composite_ms=composite_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            case["launches_by_head_dim"] = expect_head_dim("B3", before, D // H, (B, L, D, H, causal, str(dtype)))
            if L == STEP_L:
                with torch.inference_mode():
                    case["attention_ms"] = kernel_ms(lambda: ab.attention_block_inference(*args, H, causal),
                                                     B3_ATTENTION)
                case["sdpa_ms"] = attention_yardstick_ms(B, L, D, H, causal, dtype)[0]
            cases.append(case)
            log("kernel", json.dumps(case))
    return cases


def bwd_bound_ms(B, L, D, H, causal, dtype, peaks):
    """(ms, "operations" | "bytes") for one backward call (B2).  FLOPs:
    2BLD^2 (do) + 12BLD^2 (dWqkv and dY) + 2BLD^2 (dWout) + 10BL^2D (the
    five L x L products, halved by the causal mask); bytes: x, g, o, q, k, v
    read and dx written once, lse, the four D x D matrices, and the fp32
    dWqkv, dbqkv, dscale, dbias, dWout and dbout."""
    flops = 16 * B * L * D * D + 10 * B * L * L * D * (0.5 if causal else 1.0)
    el = torch.finfo(dtype).bits // 8
    nbytes = 7 * B * L * D * el + B * L * H * 4 + 4 * D * D * el + (4 * D * D + 6 * D) * 4
    t_ops, t_bytes = flops / peaks[dtype], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_norm(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def check_close(name, got, ref, tol, where, rtol=None) -> float:
    """Elementwise |got - ref| <= tol + rtol |ref| (rtol defaults to tol; tol
    a number, or a tensor of each element's own), all finite; the max abs
    error."""
    rtol = tol if rtol is None else rtol
    err = (got.float() - ref.float()).abs()
    bad = int((err > tol + rtol * ref.float().abs()).sum())
    if not bool(torch.isfinite(got).all()) or bad:
        past = "their own tolerance" if torch.is_tensor(tol) else tol
        raise AssertionError(f"{name} disagrees at {where}: {bad} elements past {past}, max abs err "
                             f"{err.max().item()}")
    return err.max().item()


def plain_lse(q, k, heads, causal):
    """fp32 log-sum-exp [B, L, H] of the scores T(q * scale) k^T, plain
    (scale = head_dim ** -0.5)."""
    qs = (q.float() * (q.shape[-1] // heads) ** -0.5).to(q.dtype)
    return torch.logsumexp(ab._scores(qs, k, heads, causal), dim=-1).transpose(1, 2)


def phase_train_kernels(peaks):
    """B1 and B2 against their plain versions; per-shape cases of each."""
    fwd_cases, bwd_cases = [], []
    for B, L, D, H, causal, dtypes in TRAIN_SHAPES:
        for dtype in dtypes:
            where = (B, L, D, H, causal, str(dtype))
            before = head_dim_launches()
            args = block_inputs(B, L, D, dtype, seed=L + 1)
            x, ln_s, ln_b, wqkv, bqkv, wout, bout = args
            g = torch.randn(B, L, D, generator=torch.Generator().manual_seed(L)).cuda().to(dtype)
            with torch.no_grad():
                got = ab._fwd_kernel_call(*args, H, causal, train=True)
                torch.cuda.synchronize()
                ref = ab.attention_block_reference(*args, H, causal)
                fwd_err = {n: check_close(f"B1 {n}", a, r, TOL[dtype], where)
                           for n, a, r in zip(("out", "o", "q", "k", "v"), got, ref)}
                _, o, q, k, v, lse = got
                fwd_err["lse"] = check_close("B1 lse", lse, ref[5], LSE_TOL[dtype], where, rtol=0.0)
                fwd_err["lse_own_qk"] = check_close("B1 lse (its own q, k)", lse, plain_lse(q, k, H, causal),
                                                    LSE_OWN_TOL, where, rtol=0.0)
                bwd_args = (g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, causal)
                dx, *sums = ab._bwd_kernel_call(*bwd_args)
                torch.cuda.synchronize()
                ref_b = ab.attention_block_backward_reference(*bwd_args)
            elem, norm, auto_norm = BWD_TOL[dtype]
            dx_err = check_close("B2 dx", dx, ref_b[0], elem, where)
            names = ("dscale", "dbias", "dwqkv", "dbqkv", "dwout", "dbout")
            rels = {n: rel_norm(a, r) for n, a, r in zip(names, sums, ref_b[1:])}
            inputs = [t.detach().clone().requires_grad_(True) for t in args]
            auto = torch.autograd.grad(ab.attention_block_reference(*inputs, H, causal)[0], inputs, g)
            auto_rels = {n: rel_norm(a, r) for n, a, r in zip(("dx",) + names, (dx, *sums), auto)}
            del auto, inputs
            if max(rels.values()) > norm or max(auto_rels.values()) > auto_norm:
                raise AssertionError(f"B2 sums disagree at {where}: plain {rels}, autograd {auto_rels}")

            with torch.no_grad():
                fwd_ms = cuda_ms(lambda: ab._fwd_kernel_call(*args, H, causal, train=True))
                fwd_plain_ms = cuda_ms(lambda: ab.attention_block_reference(*args, H, causal))
                bwd_ms = cuda_ms(lambda: ab._bwd_kernel_call(*bwd_args))
                bwd_plain_ms = cuda_ms(lambda: ab.attention_block_backward_reference(*bwd_args))
            yin = [t.detach().clone().requires_grad_(True) for t in args]
            fwd_comp_ms = cuda_ms(lambda: yardstick(*yin, H, causal))
            yout = yardstick(*yin, H, causal)
            bwd_comp_ms = cuda_ms(lambda: torch.autograd.grad(yout, yin, g, retain_graph=True))
            del yin, yout
            common = dict(B=B, L=L, D=D, H=H, causal=causal, dtype=str(dtype).split(".")[-1])
            f_bound, f_by = block_bound_ms(B, L, D, causal, dtype, peaks)
            b_bound, b_by = bwd_bound_ms(B, L, D, H, causal, dtype, peaks)
            fwd_cases.append(dict(common, max_abs_err=fwd_err["out"], errs=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                                  composite_ms=fwd_comp_ms, bound_ms=f_bound, bound_by=f_by))
            bwd_cases.append(dict(common, max_abs_err=dx_err, rel_err=rels, rel_err_autograd=auto_rels, ms=bwd_ms,
                                  plain_ms=bwd_plain_ms, composite_ms=bwd_comp_ms, bound_ms=b_bound, bound_by=b_by))
            if L > 256 and dtype == torch.bfloat16:
                fwd_cases[-1]["edge_key"] = edge_key_block_check(B, L, D, H, where)
            fwd_cases[-1]["launches_by_head_dim"] = expect_head_dim("B1 and B2", before, D // H, where)
            if L == STEP_L:
                sdpa_f, sdpa_b = attention_yardstick_ms(B, L, D, H, causal, dtype)
                with torch.no_grad():
                    fwd_cases[-1].update(attention_ms=kernel_ms(
                        lambda: ab._fwd_kernel_call(*args, H, causal, train=True), B1_ATTENTION), sdpa_ms=sdpa_f)
                    bwd_cases[-1].update(attention_ms=kernel_ms(lambda: ab._bwd_kernel_call(*bwd_args), B2_ATTENTION),
                                         sdpa_ms=sdpa_b)
            log("B1", json.dumps(fwd_cases[-1]))
            log("B2", json.dumps(bwd_cases[-1]))
    return fwd_cases, bwd_cases


# The five products of csrc/gemm_sm90.cuh alone (G1-G5, ops/gemm_sm90.py):
# at the training main path's vision shape (batch 256, L=197, D=768), its
# text shape (batch 256, L=32, D=512) and the text tower's L=77 at batch 64
# (M = 4,928, not a multiple of the 128-row tile).
GEMM_SHAPES = [("vision", 256 * 197, 768), ("text", 256 * 32, 512), ("text L=77", 64 * 77, 512)]
GEMM_REFUSED = [(512, 200, "D=200"), (512, 64, "D=64")]


def gemm_bound_ms(name, M, D, peaks, Dv=None):
    """(ms, "operations" | "bytes"): max(2MNK / bf16 peak, bytes / bandwidth),
    each input read once and each output written once."""
    t_ops = gs.product_flops(name, M, D, Dv) / peaks[torch.bfloat16]
    t_bytes = gs.product_bytes(name, M, D, Dv) / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def gemm_library_call(name, ops):
    """One ``torch.mm`` over the product's operands (relaid out beforehand,
    untimed, so one call covers G1's three towers and G4/G5's three terms;
    fp32 out for G4 and G5 where torch has ``out_dtype``): timed only, the
    port never calls it."""
    f32 = {"out_dtype": torch.float32} if tip.has_out_dtype("mm") else {}
    if name == "G1":
        y, w, _ = ops
        wc = w.permute(1, 0, 2).reshape(w.shape[1], -1).contiguous()
        return lambda: torch.mm(y, wc)
    if name == "G2":
        o, w, _, _ = ops
        return lambda: torch.mm(o, w)
    if name == "G3":
        g, w = ops
        return lambda: torch.mm(g, w.t())
    if name == "G4":
        y, d = ops
        dc = d.permute(1, 0, 2).reshape(d.shape[1], -1).contiguous()
        return lambda: torch.mm(y.t(), dc, **f32)
    d, w = ops
    dc = d.permute(1, 0, 2).reshape(d.shape[1], -1).contiguous()
    wc = w.transpose(1, 2).reshape(-1, w.shape[1]).contiguous()
    return lambda: torch.mm(dc, wc, **f32)


def gemm_case(name, label, M, D, peaks, Dv=None) -> dict:
    """Product ``name`` at ``M`` rows, width ``D`` and shard width ``Dv``:
    its output poisoned with NaN before the launch and checked (testing.py's
    check_gemm_product), a second launch bit-equal to the first, timed
    beside the plain version, torch.mm and the card's bound.  G3, which has
    no epilogue, is also held to torch.mm's bf16 product by the same
    rounding rule."""
    op, plain, _ = gs.PRODUCTS[name]
    where = (name, label, M, D, Dv)
    ops = gs.product_operands(name, M, D, "cuda", seed=M + D, Dv=Dv)
    shape, dtype = gs.product_output(name, M, D, Dv)
    got = op(*ops, out=torch.full(shape, float("nan"), dtype=dtype, device="cuda"))
    torch.cuda.synchronize()
    errs = check_gemm_product(name, got, ops, where)
    if not torch.equal(got, op(*ops)):
        raise AssertionError(f"{name} differs between two launches at {where}")
    library = gemm_library_call(name, ops)
    if name == "G3":
        errs["vs_torch_mm"] = check_rounded_product(name, got, library(), [(ops[0], ops[1].t())], where)["max_abs"]
    ms = cuda_ms(lambda: op(*ops))
    plain_ms = cuda_ms(lambda: plain(*ops))
    library_ms = cuda_ms(library)
    bound, by = gemm_bound_ms(name, M, D, peaks, Dv)
    case = dict(product=name, shape=label, M=M, D=D, Dv=D if Dv is None else Dv,
                max_abs_err=errs["max_abs_vs_plain"], errs=errs, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=by, tflops=gs.product_flops(name, M, D, Dv) / ms / 1e9)
    log("gemm", json.dumps(case))
    return case


def phase_gemm(peaks) -> list:
    """G1-G5 alone at GEMM_SHAPES: each output poisoned with NaN before the
    launch and checked (testing.py's check_gemm_product), a second launch
    bit-equal to the first, timed beside the plain version, torch.mm and
    the card's bound; then shapes the kernel cannot tile must raise
    ValueError naming D."""
    cases = [gemm_case(name, label, M, D, peaks) for label, M, D in GEMM_SHAPES for name in gs.PRODUCTS]
    for M, D, dim in GEMM_REFUSED:
        y = torch.zeros(M, D, dtype=torch.bfloat16, device="cuda")
        w = torch.zeros(3, D, D, dtype=torch.bfloat16, device="cuda")
        try:
            gs.qkv_product(y, w, torch.zeros(3, D, device="cuda"))
        except ValueError as e:
            if dim not in str(e):
                raise AssertionError(f"G1 refused M={M} D={D} without naming {dim}: {e}") from e
            log(f"G1 refuses M={M} D={D}: {e}")
            continue
        raise AssertionError(f"G1 accepted D={D}, which its tiles cannot cover")
    torch.cuda.empty_cache()
    return cases


def chunks(n: int) -> int:
    return math.ceil(n / BUCKETS[-1])


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_serving(tmp: str, card: str) -> dict:
    t0 = time.perf_counter()
    cfg = SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="float32", seed=0)
    cpu_model = build_clip_model(cfg, device="cpu")
    ckpt = os.path.join(tmp, "vit_b16_random.pt")
    convert.save_torch_checkpoint(ckpt, convert.export_clip_state_dict(cpu_model.state_dict(), cpu_model.config))
    log(f"random-init {MODEL} written to a .pt in {time.perf_counter() - t0:.1f} s")

    layers_v, layers_t = cpu_model.config.vision.layers, cpu_model.config.text.layers
    px = cpu_model.config.vision.image_size
    rng = np.random.default_rng(0)
    reset_counts()
    # ---- the main path: counts start at 0 here --------------------------
    srv = ClipServer.from_checkpoint(ckpt, model=MODEL, classnames=CLASSNAMES, template=simple_template,
                                     compute_dtype="bfloat16", device="cuda", image_buckets=BUCKETS)
    expected = layers_t * 1  # the zero-shot head: 5 prompts, one text chunk
    n_warm = srv.warmup()
    expected += layers_v * 2 * len(BUCKETS) + layers_t * 2 * len(BUCKETS)
    assert n_warm == 4 * len(BUCKETS), n_warm
    results = {}
    for n in (5, 64, 300):
        imgs = rng.standard_normal((n, px, px, 3)).astype(np.float32)
        logits = srv.classify(imgs)
        expected += layers_v * chunks(n)
        assert logits.shape == (n, len(CLASSNAMES)) and logits.dtype == np.float32
        assert np.isfinite(logits).all()
        results[n] = (imgs, logits)
    imgs, logits = results[64]
    probs, idx = srv.top_k(imgs, k=3)
    expected += layers_v * chunks(64)
    assert (np.diff(probs, axis=1) <= 0).all() and (idx[:, 0] == logits.argmax(1)).all()
    caps = [f"a photo of a {c}." for c in CLASSNAMES] * 60
    txt = srv.encode_texts(caps)
    expected += layers_t * chunks(len(caps))
    assert txt.shape == (len(caps), cpu_model.config.embed_dim) and np.isfinite(txt).all()
    np.testing.assert_allclose(np.linalg.norm(txt, axis=1), 1.0, atol=1e-2)
    streamed = list(srv.stream_logits([results[5][0], results[64][0]]))
    expected += layers_v * 2
    launches = counts()["B3"]
    # ---- end of the main path -------------------------------------------
    expect_counts("serving main path", B3=expected)
    log(f"main path: {launches} attention-block kernel launches, as expected")
    np.testing.assert_allclose(streamed[0], results[5][1], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(streamed[1], results[64][1], atol=1e-5, rtol=1e-5)

    # Features of 4 images from the card against the CPU plain forward.
    four = results[5][0][:4]
    with torch.inference_mode():
        ref = cpu_model.encode_image(torch.from_numpy(four), normalize=True).numpy()
    fp32_srv = ClipServer.from_checkpoint(ckpt, model=MODEL, compute_dtype="float32", device="cuda",
                                          image_buckets=BUCKETS)
    cos32 = cosine(fp32_srv.encode_images(four), ref)
    cos16 = cosine(srv.encode_images(four), ref)
    log(f"cosine to the CPU plain forward: fp32 {cos32.min():.7f}, bf16 {cos16.min():.5f}")
    if cos32.min() < 0.9999 or cos16.min() < 0.99:
        raise AssertionError(f"features drift from the CPU plain forward: fp32 {cos32}, bf16 {cos16}")
    del fp32_srv

    rates = {}
    for b in (64, 256):
        batch = rng.standard_normal((b, px, px, 3)).astype(np.float32)
        srv.classify(batch)
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            srv.classify(batch)
        rates[b] = reps * b / (time.perf_counter() - t0)
        log(f"classify, bucket {b}, bf16: {rates[b]:.1f} img/s on {card}")
    breakdown = device_profile(lambda: srv.classify(batch),
                               {"attention_block": B3_KERNELS, "B3_attention": B3_ATTENTION})
    if breakdown:
        breakdown["rows"] = len(batch)
    http = surface_http(srv, card)  # phase 14 (a), over this server before it is dropped
    return {"launches": launches, "cos_fp32": float(cos32.min()), "cos_bf16": float(cos16.min()), "img_s": rates,
            "breakdown": breakdown, "http": http}


# Kernel names by port kernel, as the profiler reports them.  The bf16 GEMM
# (gemm_sm90.cuh) takes <tile width, A MN-major, B MN-major, kOps, TOut>: the
# forwards' QKV and out-projection (G1, G2) hold B MN-major, the backward's
# do and dY (G3, G5) both operands K-major, its dWqkv (G4) both MN-major.
# The fp32 GEMM (common.cuh) takes <kAT, kBT, kOps>: the forwards hold both
# operands untransposed, the backward's do and dY hold B transposed and its
# dWqkv A transposed.  ln_forward_kernel (y = LN(x), once per row) runs in
# B1, B2 and B3 and is its own group in the training profile.  The
# attention templates (attention.cuh) take kScaleQ (true for the attention
# block's kernels, false for B5/B6) first and kTrain second in the forwards
# (attention_fwd_kernel, the register route of bf16 rows up to 256 keys;
# attention_fwd_stream_kernel, the streamed route of longer bf16 rows;
# attention_fma_kernel, fp32), and kScaleQ last in the backward passes
# (attention_bwd_q_kernel and attention_bwd_k_kernel;
# attention_bwd_q_stream_kernel and attention_bwd_k_stream_kernel;
# attention_bwd_dq_kernel and attention_bwd_dkv_kernel).  The patterns name
# no route, so they also read a tree whose routes are named otherwise (the
# parent of an A/B).
_FWD_GEMM = r"(gemm_fma_kernel<false, false, |gemm_sm90_kernel<\d+, false, true, )"
LN_FORWARD = r"ln_forward_kernel"
B3_ATTENTION = r"attention_\w+_kernel<true, false"
B1_ATTENTION = r"attention_\w+_kernel<true, true"
B2_ATTENTION = r"attention_bwd_\w+_kernel<[^>]*true>"
B3_KERNELS = rf"({_FWD_GEMM}|{B3_ATTENTION}|{LN_FORWARD})"
B1_KERNELS = rf"({_FWD_GEMM}|{B1_ATTENTION})"
B2_KERNELS = (rf"(gemm_fma_kernel<(true, false|false, true), |gemm_sm90_kernel<\d+, (false, false|true, true), |"
              rf"{B2_ATTENTION}|ln_backward_kernel|colsum_partial_kernel|reduce_partials_kernel)")
PORT_KERNELS = r"(flyp::|\(anonymous namespace\)::)"  # every kernel of csrc/, none of PyTorch's


def device_profile(fn, groups: dict) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler): each
    group's share of the device time (groups map a name to a regex of kernel
    names), the busy share of the call's wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    rows = []  # kernel rows only: operator rows repeat their kernels' time
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, evt.key))
    rows.sort(reverse=True)
    busy = sum(d for d, _ in rows)
    if busy == 0:
        log("profile: the trace shows no device time (not measured)")
        return {}
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3, "busy_share": busy / wall_us}
    for name, pattern in groups.items():
        out[f"{name}_share"] = sum(d for d, k in rows if re.search(pattern, k)) / busy
    out["top"] = [[k[:100], d / 1e3] for d, k in rows[:10]]
    log("profile " + json.dumps(out))
    return out


def loss_and_grads(model, images, tokens):
    """The train step's forward and backward, without the update."""
    img_f, txt_f, scale = model(images, tokens)
    loss = clip_loss(img_f, txt_f, scale).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.item(), [g.float().cpu() for g in grads]


def grad_cosines(grads, ref) -> list:
    """Per-parameter cosine (1.0 where both gradients are exactly zero)."""
    out = []
    for a, b in zip(grads, ref):
        a, b = a.double().ravel(), b.double().ravel()
        na, nb = a.norm(), b.norm()
        out.append(1.0 if na == 0 and nb == 0 else float(a @ b / (na * nb)))
    return out


# Each kernel's launch counter: (the op carrying it, its attribute).
COUNTERS = {
    "B3": (ab.attention_block_inference, "launches"),
    "B1": (ab.attention_block, "fwd_launches"),
    "B2": (ab.attention_block, "bwd_launches"),
    "B4": (mb.mlp_block, "fwd_launches"),
    "B5_fwd": (fq.fused_qkv_attention, "fwd_launches"),
    "B5_bwd": (fq.fused_qkv_attention, "bwd_launches"),
    "B6_fwd": (fa.flash_attention, "fwd_launches"),
    "B6_bwd": (fa.flash_attention, "bwd_launches"),
    "T1_bf16": (tip.probe_mm, "bf16_launches"),
    "T1_int8": (tip.probe_mm, "int8_launches"),
    "T2": (tml.score_depth, "launches"),
    "T3": (tml.row_gemm, "launches"),
    "T4": (tml.adamw_update, "launches"),
}


def counts() -> dict:
    return {name: getattr(op, attr) for name, (op, attr) in COUNTERS.items()}


def reset_counts():
    for op, attr in COUNTERS.values():
        setattr(op, attr, 0)
    for op, attr in HEAD_DIM_COUNTERS:
        setattr(op, attr, dict.fromkeys(getattr(op, attr), 0))


# B3's, B1's and B2's launches by head width (64, or 80 on the streamed route).
HEAD_DIM_COUNTERS = ((ab.attention_block_inference, "launches_by_head_dim"),
                     (ab.attention_block, "fwd_launches_by_head_dim"),
                     (ab.attention_block, "bwd_launches_by_head_dim"))


def head_dim_launches() -> collections.Counter:
    """B1-B3's launches so far, by head width."""
    total = collections.Counter()
    for op, attr in HEAD_DIM_COUNTERS:
        total.update(getattr(op, attr))
    return total


def expect_head_dim(name: str, before: collections.Counter, head_dim: int, where) -> dict:
    """The launches since ``before`` ({head width: count}), all at ``head_dim``."""
    ran = head_dim_launches() - before
    if set(ran) != {head_dim}:
        raise AssertionError(f"{name} at {where}: launches by head width {dict(ran)}, expected all at {head_dim}")
    return dict(ran)


def expect_counts(where: str, **expected):
    """Every kernel's launches since the reset, exactly: ``expected`` for the
    named ones, 0 for every other."""
    want = {name: expected.get(name, 0) for name in COUNTERS}
    if counts() != want:
        raise AssertionError(f"{where}: launches {counts()}, expected {want}")


def use_impl(impl: str):
    """``FLYP_ATTENTION_IMPL`` for what follows (the port reads it once and
    caches the choice)."""
    os.environ[attention_dispatch._IMPL_ENV] = impl
    attention_dispatch._default_impl.cache_clear()


def model_shape():
    """(image size, vision layers, text layers) of the model."""
    c = MODEL_CONFIGS[MODEL]
    return c.vision.image_size, c.vision.layers, c.text.layers


# The depth of the trainer paths (phase 10's ViT-B/16, phase 11's RN50
# trainer), cut to keep the script within its time limit: full width, every
# resume, bit-equality and launch check kept.
TRAINER_DEPTH = {MODEL: dict(vision_layers=4, text_layers=4)}
RN_TRAINER_DEPTH = dict(resnet_layers=(1, 1, 1, 1), text_layers=4)


@contextlib.contextmanager
def cut_depth(name: str, vision_layers=None, text_layers=None, resnet_layers=None):
    """``MODEL_CONFIGS[name]`` with fewer layers for the body (the factory
    and ``model_shape`` read it there); the widths stay."""
    real = MODEL_CONFIGS[name]
    vision, text = real.vision, real.text
    if vision_layers is not None:
        vision = dataclasses.replace(vision, layers=vision_layers)
    if resnet_layers is not None:
        vision = dataclasses.replace(vision, resnet_layers=tuple(resnet_layers))
    if text_layers is not None:
        text = dataclasses.replace(text, layers=text_layers)
    MODEL_CONFIGS[name] = dataclasses.replace(real, vision=vision, text=text)
    try:
        yield MODEL_CONFIGS[name]
    finally:
        MODEL_CONFIGS[name] = real


def step_check(cfg: dict, images, tokens, where: str) -> dict:
    """One step's loss and gradients at B=4, full width: the card (kernels)
    against the CPU (plain versions), fp32; bf16 on the card against the
    same fp32 reference."""
    out = {}
    t0 = time.perf_counter()
    cpu = build_clip_model(cfg["float32"], device="cpu").train().requires_grad_(True)
    ref_loss, ref_grads = loss_and_grads(cpu, torch.from_numpy(images), torch.from_numpy(tokens))
    del cpu
    log(f"CPU plain step ({where}), fp32, B=4: loss {ref_loss:.7f} in {time.perf_counter() - t0:.1f} s")
    for name, min_cos, loss_tol in (("float32", 0.9999, 1e-4), ("bfloat16", 0.99, 2e-2)):
        model = build_clip_model(cfg[name], device="cuda").train().requires_grad_(True)
        loss, grads = loss_and_grads(model, torch.from_numpy(images).cuda(), torch.from_numpy(tokens).cuda())
        cos = grad_cosines(grads, ref_grads)
        rel = abs(loss - ref_loss) / abs(ref_loss)
        log(f"card step ({where}), {name}, B=4: loss {loss:.7f} (rel err {rel:.3g}), min grad cosine {min(cos):.7f}")
        if rel > loss_tol or min(cos) < min_cos:
            names = [n for n, _ in model.named_parameters()]
            worst = sorted(zip(cos, names))[:5]
            raise AssertionError(f"{name} step ({where}) drifts from the CPU plain step: loss rel err {rel}, "
                                 f"worst {worst}")
        out[f"loss_rel_err_{name}"], out[f"min_grad_cosine_{name}"] = rel, min(cos)
        del model, grads
    return out


def phase_training(card: str) -> dict:
    cfg = {n: SimpleNamespace(model=MODEL, clip_load=None, compute_dtype=n, seed=0) for n in ("float32", "bfloat16")}
    out = {}

    # 1. One step's loss and gradients at B=4, full width, against the CPU.
    px, layers_v, layers_t = model_shape()
    images, tokens = bench_batch(4, px, seed=1)
    out.update(step_check(cfg, images, tokens, "pallas_block"))

    # 2, 3. The bench configuration, launches counted exactly.
    model = build_clip_model(cfg["bfloat16"], device="cuda")
    head_before = get_zeroshot_classifier(model, CLASSNAMES, simple_template)
    state, step, images, tokens, res = bench_training(model, "pallas_block", card)
    out.update(res, layers_train_ms=layer_ms(model, train=True))

    # 4. Learning: 8 steps on one repeated batch of 64 at a rate of 1e-4.
    fast = make_optimizer(warmup_cosine_lr(1e-4, 1, 10_000), weight_decay=0.1, moment_dtype="bfloat16")
    fast_state = create_train_state(model, fast)
    fast_step = make_train_step(model, fast)
    losses = [float(fast_step(fast_state, images[:64], tokens[:64])[1]["loss"]) for _ in range(8)]
    log(f"learning check, 8 steps at 1e-4 on one batch of 64: {[round(v, 5) for v in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    out["learning_losses"] = losses

    # 5. The epoch's end: eval mode, the head rebuilt from the trained text
    # tower, the classifier on 64 images; the inference kernel only.
    model.eval()
    reset_counts()
    head = get_zeroshot_classifier(model, CLASSNAMES, simple_template)
    expect_counts("head rebuild", B3=layers_t)  # one text chunk: 5 prompts
    head_change = float((head.weight - head_before.weight).abs().max())
    if head_change == 0.0:
        raise AssertionError("the zero-shot head did not change with training")
    eval_images, _ = bench_batch(64, px, seed=2)
    logits = Classifier(model, head, batch_size=64).predict_logits(eval_images)
    labels = np.random.default_rng(2).integers(0, len(CLASSNAMES), 64)
    top1 = topk_accuracy(logits, labels)[0] / 64
    expect_counts("head rebuild and classifier", B3=layers_t + layers_v)
    if logits.shape != (64, len(CLASSNAMES)) or not np.isfinite(logits).all():
        raise AssertionError(f"classifier: logits {logits.shape}")
    out.update(head_change=head_change, top1=top1, layers_eval_ms=layer_ms(model, train=False))
    log(f"epoch end: head rebuilt (max change {head_change:.4g}), classifier top-1 {top1:.4f} on random labels")

    # 6. Profile of one train step.
    model.train()
    out["profile"] = device_profile(lambda: step(state, images, tokens),
                                    {"B1": B1_KERNELS, "B2": B2_KERNELS, "ln_forward": LN_FORWARD,
                                     "B1_attention": B1_ATTENTION, "B2_attention": B2_ATTENTION,
                                     "port_kernels": PORT_KERNELS})
    return out


def bench_training(model, impl: str, card: str):
    """13 steps of the bench configuration (batch 256, bf16, bf16 Adam
    moments) under the route ``impl``, with every kernel's launches checked
    exactly (the route's own kernels once per block per step, no other):
    ``(state, step, images, tokens, results)``.  A ModifiedResNet's image
    tower has no transformer blocks (its config's ``layers`` is 0)."""
    c = model.config
    px, layers_v, layers_t = c.vision.image_size, c.vision.layers, c.text.layers
    opt = make_optimizer(warmup_cosine_lr(1e-5, 500, 10_000), weight_decay=0.1, moment_dtype="bfloat16")
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    images, tokens = bench_batch(256, px, seed=0)
    images = torch.from_numpy(images).to(torch.bfloat16).cuda()
    tokens = torch.from_numpy(tokens).cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # ---- the training path under this route: counts start at 0 here ------
    for _ in range(3):
        state, metrics = step(state, images, tokens)
    first_loss = float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(10):
        state, metrics = step(state, images, tokens)
    last_loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    launches = counts()
    # ---- end of the training path -----------------------------------------
    expect_counts(f"training under {impl}, 13 steps", **{k: 13 * (layers_v + layers_t) for k in ROUTE_TRAIN[impl]})
    if not (math.isfinite(first_loss) and math.isfinite(last_loss)):
        raise AssertionError(f"non-finite loss under {impl}: {first_loss}, {last_loss}")
    res = dict(train_img_s=10 * 256 / dt, step_ms=dt / 10 * 1e3, loss=[first_loss, last_loss], train_launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30, tokens_width=int(tokens.shape[1]))
    log(f"train under {impl}, batch 256, bf16: {res['train_img_s']:.2f} img/s ({res['step_ms']:.2f} ms/step), loss "
        f"{first_loss:.5f} -> {last_loss:.5f}, peak memory {res['peak_mem_gb']:.2f} GiB, launches {launches} "
        f"on {card}")
    return state, step, images, tokens, res


def default_route_rates(card: str) -> dict:
    """ViT-B/16 on the default route, bf16, random weights from seed 0:
    train img/s over ``bench_training``'s 13 steps at batch 256 (launches
    exact) and serve img/s of ``ClipServer.classify`` at bucket 256 (10
    calls after one, as phase 4 times it; B3 counted).  ``python3
    chip_smoke.py --default-route`` prints only these: the quick A/B of a
    change to code the default route shares."""
    cfg = SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="bfloat16", seed=0)
    model = build_clip_model(cfg, device="cuda")
    train = bench_training(model, "pallas_block", card)[-1]
    srv = ClipServer.for_classification(model, CLASSNAMES, simple_template, image_buckets=(256,))
    layers_v = model.config.vision.layers
    px = model.config.vision.image_size
    batch = np.random.default_rng(0).standard_normal((256, px, px, 3)).astype(np.float32)
    srv.classify(batch)
    reps = 10
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        srv.classify(batch)
    serve = reps * 256 / (time.perf_counter() - t0)
    expect_counts(f"{reps} classify calls of 256 images", B3=reps * layers_v)
    log(f"default route: train {train['train_img_s']:.2f} img/s, serve {serve:.1f} img/s at bucket 256 on {card}")
    return {"train_img_s": train["train_img_s"], "step_ms": train["step_ms"], "serve_img_s": serve}


# The input phase's corpus: 512 source images with sides of 256-512 px
# (smooth gradients plus noise, so that they compress as photographs do),
# most as PNG, 16 as uint8 and 16 as float .npy, plus the committed JPEG
# fixtures; 14 batches of 256 caption rows over them, two guidance levels;
# three tar shards of the same images and captions.
INPUT_SOURCES, INPUT_NPY = 512, 32
INPUT_BATCH, INPUT_BATCHES = 256, 14
INPUT_WORKERS = 6  # --workers' default
INPUT_SHARDS, INPUT_TAR_STEPS = 3, 2
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "torch_data")


def png_bytes(arr: np.ndarray) -> bytes:
    """An 8-bit RGB PNG with zlib alone: filter Up on every row but the first."""
    import struct
    import zlib

    h, w, _ = arr.shape
    rows = arr.reshape(h, w * 3)
    filtered = rows.copy()
    filtered[1:] -= rows[:-1]
    raw = np.hstack([np.full((h, 1), 2, np.uint8), filtered])
    raw[0, 0] = 0

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def corpus_image(seed: int, i: int, high: int = 513) -> np.ndarray:
    """A photograph-like image of sides 256 to ``high - 1`` px."""
    rng = np.random.default_rng([seed, i])
    h, w = (int(v) for v in rng.integers(256, high, 2))
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy, p = rng.uniform(0.004, 0.04), rng.uniform(0.004, 0.04), rng.uniform(0, 6, 3)
    base = np.stack([128 + 70 * np.sin(x * fx + p[c]) * np.cos(y * fy + 2 * p[c]) + 50 * (x / w - y / h) * (c - 1)
                     for c in range(3)], axis=-1)
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def write_corpus(root: str, seed: int):
    """(TSV path, tar shard pattern, samples in the shards)."""
    import io
    import tarfile
    from concurrent.futures import ThreadPoolExecutor

    from flyp_tpu_torch.data.classnames import openai_classnames

    def write(i: int):
        arr = corpus_image(seed, i)
        if i < INPUT_NPY:
            path = os.path.join(root, f"src{i:04d}.npy")
            np.save(path, arr if i % 2 else arr.astype(np.float32) / 255.0)
            return path, None
        path = os.path.join(root, f"src{i:04d}.png")
        data = png_bytes(arr)
        with open(path, "wb") as f:
            f.write(data)
        return path, data

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        files = list(pool.map(write, range(INPUT_SOURCES)))
    for name in sorted(os.listdir(JPEG_FIXTURES)):
        path = os.path.join(JPEG_FIXTURES, name)
        with open(path, "rb") as f:
            files.append((path, f.read()))
    rows = ["title\tfilepath\tlabel\tguidance\timg_id"]
    captions = []
    for r in range(INPUT_BATCH * INPUT_BATCHES):
        label = (7 * r) % len(openai_classnames)
        captions.append(f"a photo of a {openai_classnames[label]}.")
        rows.append(f"{captions[-1]}\t{files[r % len(files)][0]}\t{label}\t{(100, 50)[r % 2]}\t{r // 2}")
    tsv = os.path.join(root, "train.tsv")
    with open(tsv, "w") as f:
        f.write("\n".join(rows) + "\n")
    encoded = [(i, path, data) for i, (path, data) in enumerate(files) if data is not None]
    sizes = {}
    for s in range(INPUT_SHARDS):
        name = f"shard-{s:05d}.tar"
        members = encoded[s::INPUT_SHARDS]
        with tarfile.open(os.path.join(root, name), "w") as tf:
            for i, path, data in members:
                for ext, body in ((path.rsplit(".", 1)[1], data), ("txt", captions[i].encode())):
                    info = tarfile.TarInfo(f"{i:06d}.{ext}")
                    info.size = len(body)
                    tf.addfile(info, io.BytesIO(body))
        sizes[name] = len(members)
    with open(os.path.join(root, "sizes.json"), "w") as f:
        json.dump(sizes, f)
    return tsv, os.path.join(root, "shard-{00000..%05d}.tar" % (INPUT_SHARDS - 1)), sum(sizes.values())


def batch_digests(batch: dict) -> dict:
    return {k: digest((v,)) for k, v in sorted(batch.items()) if isinstance(v, torch.Tensor)}


def host_digests(batch: dict) -> dict:
    """What the prefetch must deliver for a host batch: images cast to bf16,
    tokens cut by ``shrink_context``."""
    return {"image": digest((torch.from_numpy(batch["image"]).to(torch.bfloat16),)),
            "tokens": digest((torch.from_numpy(shrink_context(batch["tokens"])),))}


def loader_rate(cfg, px: int, workers: int, batches: int = 6) -> dict:
    """The loader alone at ``workers`` threads: one batch to fill the
    window, then ``batches`` timed."""

    from flyp_tpu_torch.training.data import train_loader

    it = iter(train_loader(dataclasses.replace(cfg, workers=workers), px))
    t0 = time.perf_counter()
    next(it)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    dt = time.perf_counter() - t0
    it.close()
    return {"workers": workers, "img_s": batches * INPUT_BATCH / dt, "first_batch_s": first}


def native_costs(dataset, px: int, n: int = 64) -> dict:
    """One thread over the first ``n`` PNG rows: ms per image in native
    decode (file read included) and in the train transform."""
    from flyp_tpu_torch.data import native_decode

    decode_s = transform_s = 0.0
    paths = [p for p in dataset.images if p.endswith(".png")][:n]
    for i, path in enumerate(paths):
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            rgb = native_decode.decode(f.read())
        t1 = time.perf_counter()
        native_decode.train_transform_from_rgb(rgb, px, np.random.default_rng(i))
        decode_s += t1 - t0
        transform_s += time.perf_counter() - t1
    n = len(paths)
    return {"images": n, "decode_ms": decode_s / n * 1e3, "transform_ms": transform_s / n * 1e3}


def batch_costs(batch: dict) -> dict:
    """ms per batch of 256: collate (``np.stack`` of the samples), the bf16
    cast into pinned memory, and the copy to the card (CUDA events)."""
    from flyp_tpu_torch.data.loader import _collate

    samples = [{k: v[i] for k, v in batch.items()} for i in range(len(batch["image"]))]
    t0 = time.perf_counter()
    collated = _collate(samples)
    collate_ms = (time.perf_counter() - t0) * 1e3
    host = torch.from_numpy(collated["image"])
    pinned = torch.empty(host.shape, dtype=torch.bfloat16, pin_memory=True)
    t0 = time.perf_counter()
    pinned.copy_(host)
    cast_ms = (time.perf_counter() - t0) * 1e3
    h2d_ms = cuda_ms(lambda: pinned.to("cuda", non_blocking=True), iters=5, warmup=1)
    return {"collate_ms": collate_ms, "cast_ms": cast_ms, "h2d_ms": h2d_ms,
            "h2d_gb_s": pinned.numel() * 2 / h2d_ms / 1e6}


def ring_check(source, host: list, where: str) -> int:
    """Every batch of ``source`` through the pinned ring at size 2, the
    consumer running a large matmul first each time and cloning the batch
    behind it on its stream before dropping it (so the copies race the
    compute, and a slot refilled early or memory reused before the consumer
    read it shows), held bit for bit to the independent host pass."""
    from flyp_tpu_torch.data.loader import prefetch_to_device

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    kept = []
    refills = prefetch_to_device.slot_refills
    for batch in prefetch_to_device(source, "cuda", size=2, image_dtype=torch.bfloat16):
        for _ in range(64):  # ~0.1 s of the consumer's stream, longer than staging a batch
            a = (a @ a).clamp_(-1, 1)
        kept.append({k: v.clone() for k, v in batch.items() if isinstance(v, torch.Tensor)})
        del batch
    torch.cuda.synchronize()
    got = [batch_digests(b) for b in kept]
    if got != host:
        bad = [n for n, (g, h) in enumerate(zip(got, host)) if g != h]
        raise AssertionError(f"{where}: device batches differ from the host pass at {bad} of {len(host)}")
    return prefetch_to_device.slot_refills - refills


def phase_input(card: str, synthetic_img_s: float, seed: int = 0) -> dict:
    """The training input pipeline at full width: parser -> CSV (and tar
    shard) loader -> native decode and transform -> bf16 host cast -> the
    pinned ring -> the default route's train step."""
    from flyp_tpu_torch.config import parse_arguments
    from flyp_tpu_torch.data import native_decode
    from flyp_tpu_torch.data.webdataset import WebDatasetLoader
    from flyp_tpu_torch.training.data import device_iter, train_loader

    t_phase = time.perf_counter()
    px, layers_v, layers_t = model_shape()
    per_step = layers_v + layers_t
    native_decode.load()  # available() or NativeCompileError with g++'s message
    out = {"codecs": native_decode.codecs(), "nproc": os.cpu_count()}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        tsv, shards, n_tar = write_corpus(root, seed)
        out["corpus_s"] = time.perf_counter() - t0
        argv = ["--ft_data", tsv, "--batch-size", str(INPUT_BATCH), "--data_backend", "native", "--workers",
                str(INPUT_WORKERS), "--model", MODEL, "--seed", str(seed)]
        cfg = parse_arguments(argv)
        loader = train_loader(cfg, px)
        if len(loader) != INPUT_BATCHES:
            raise AssertionError(f"the loader has {len(loader)} batches, expected {INPUT_BATCHES}")
        log(f"input: corpus of {INPUT_SOURCES} sources + JPEG fixtures, {len(loader.dataset)} rows, {n_tar} tar "
            f"samples in {out['corpus_s']:.1f} s; codecs {out['codecs']}, {out['nproc']} host cores")

        # The independent host pass (it also warms the tokenizer's
        # cache and the page cache for the timings after it).
        loader.set_epoch(0)
        host_batches = list(loader)
        host = [host_digests(b) for b in host_batches]
        # Host rates.
        out["rates"] = [loader_rate(cfg, px, w) for w in sorted({INPUT_WORKERS, os.cpu_count() or 1})]
        out["native"] = native_costs(loader.dataset, px)
        out["batch"] = batch_costs(host_batches[0])
        log(f"input: loader {out['rates']}, native {out['native']}, per batch {out['batch']}")
        # The epoch through the ring, from the live loader and from the
        # host batches; the fast-forward.
        loader.set_epoch(0)
        refills = ring_check(loader, host, "the live loader through the ring")
        refills += ring_check(host_batches, host, "the host batches through the ring")
        del host_batches
        loader.set_epoch(0, start_batch=5)
        it = device_iter(loader, "cuda", "bfloat16")
        forward = batch_digests(next(it))
        it.close()
        if forward != host[5]:
            raise AssertionError(f"set_epoch(0, start_batch=5) gave {forward}, batch 5 is {host[5]}")
        out.update(ring_batches=2 * len(host), ring_refills=refills, fast_forward_equal=True)
        log(f"input: {2 * len(host)} batches through the pinned ring bit-equal to the host pass ({refills} slot "
            f"refills); set_epoch(0, start_batch=5) gives batch 5")

        # Full width, fed from disk: 3 warm-up and 10 timed steps (epoch
        # 1), then one step profiled after 3 more (epoch 2), so that it
        # waits for the loader as a step in the middle of an epoch does.
        model = build_clip_model(cfg, device="cuda")
        opt = make_optimizer(warmup_cosine_lr(1e-5, 500, 10_000), weight_decay=0.1, moment_dtype="bfloat16")
        state, step = create_train_state(model, opt), make_train_step(model, opt)
        loader.set_epoch(1)
        it = device_iter(loader, "cuda", cfg.compute_dtype)
        reset_counts()
        # ---- the fed training path: counts start at 0 here ----------------
        for _ in range(3):
            batch = next(it)
            state, metrics = step(state, batch["image"], batch["tokens"])
        first_loss = float(metrics["loss"])
        t0 = time.perf_counter()
        for _ in range(10):
            batch = next(it)
            state, metrics = step(state, batch["image"], batch["tokens"])
        last_loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        launches = counts()
        # ---- end of the fed training path -----------------------------------
        it.close()
        expect_counts("training fed by the loader, 13 steps", B1=13 * per_step, B2=13 * per_step)
        if not (math.isfinite(first_loss) and math.isfinite(last_loss)):
            raise AssertionError(f"non-finite loss fed by the loader: {first_loss}, {last_loss}")
        if batch["image"].dtype != torch.bfloat16 or tuple(batch["image"].shape) != (INPUT_BATCH, px, px, 3):
            raise AssertionError(f"fed images {batch['image'].dtype} {list(batch['image'].shape)}")
        loader.set_epoch(2)
        it = device_iter(loader, "cuda", cfg.compute_dtype)
        reset_counts()
        for _ in range(3):
            batch = next(it)
            state, _ = step(state, batch["image"], batch["tokens"])

        def fed_step():
            b = next(it)
            step(state, b["image"], b["tokens"])

        out["profile"] = device_profile(fed_step, {"B1": B1_KERNELS, "B2": B2_KERNELS})
        it.close()
        expect_counts("the profiled fed step and its 3 warm-up steps", B1=4 * per_step, B2=4 * per_step)
        out.update(fed_img_s=10 * INPUT_BATCH / dt, fed_step_ms=dt / 10 * 1e3, synthetic_img_s=synthetic_img_s,
                   loss=[first_loss, last_loss], launches=launches)
        log(f"input: fed from disk, batch {INPUT_BATCH}, bf16: {out['fed_img_s']:.2f} img/s "
            f"({out['fed_step_ms']:.2f} ms/step; synthetic {synthetic_img_s:.2f}), loss {first_loss:.5f} -> "
            f"{last_loss:.5f}, busy share {out['profile'].get('busy_share')}, launches {launches} on {card}")

        # Tar shards: two steps, the sample accounting exact.
        wds_cfg = parse_arguments(["--ft_data", shards, "--train-num-samples", str(INPUT_TAR_STEPS * INPUT_BATCH),
                                   *argv[2:]])
        tar_loader = train_loader(wds_cfg, px)
        if not isinstance(tar_loader, WebDatasetLoader) or len(tar_loader) != INPUT_TAR_STEPS:
            raise AssertionError(f"tar shards: {type(tar_loader).__name__} of {len(tar_loader)} batches")
        reset_counts()
        # ---- the tar-shard training path: counts start at 0 here ------------
        tar_losses, tar_rows = [], 0
        for batch in device_iter(tar_loader, "cuda", wds_cfg.compute_dtype):
            state, metrics = step(state, batch["image"], batch["tokens"])
            tar_losses.append(float(metrics["loss"]))
            tar_rows += int(batch["image"].shape[0])
        launches = counts()
        # ---- end of the tar-shard training path -----------------------------
        expect_counts("training fed by tar shards", B1=INPUT_TAR_STEPS * per_step, B2=INPUT_TAR_STEPS * per_step)
        if len(tar_losses) != INPUT_TAR_STEPS or tar_rows != INPUT_TAR_STEPS * INPUT_BATCH:
            raise AssertionError(f"tar shards fed {len(tar_losses)} steps of {tar_rows} rows")
        if not all(math.isfinite(v) for v in tar_losses):
            raise AssertionError(f"non-finite loss fed by tar shards: {tar_losses}")
        out["tar"] = {"steps": len(tar_losses), "rows": tar_rows, "samples_in_shards": n_tar, "loss": tar_losses,
                      "launches": launches}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"input: tar shards fed {len(tar_losses)} steps of {INPUT_BATCH}; phase took {out['phase_s']:.1f} s")
    return out


# The evaluation phase's corpus (seed 0), PNGs of 256-400 px a side: the
# ImageNet val tree (1,000 class folders, 2 images each; the real set has
# 50), ImageNet-R's 200 sublist folders (1 each), ObjectNet's 113 folders (2
# each, with its red 2-px border), iWildCam's metadata.csv with 512 rows of
# IWildCamOOD's split over 60 classes, and FMoW's rgb_metadata.csv with 512
# rows of the OOD test split (2016 on) over the five named regions and
# "Other"; rows of other splits, 'seq' rows and pre-2016 test rows are in
# the metadata and must be left out.  Three zero-shot runs, each as a user
# runs ``python -m flyp_tpu_torch.cli.zeroshot_eval``.
EVAL_BATCH, EVAL_WORKERS = 256, 6
EVAL_PER_CLASS, EVAL_OBJECTNET_PER_CLASS, EVAL_WILDS_ROWS = 2, 2, 512
EVAL_FEATURES, EVAL_HEAD_CLASSES = 64, 10
EVAL_RUNS = (("ImageNet", "openai_imagenet_template", ("ImageNet", "ImageNetR", "ObjectNet")),
             ("IWildCamOOD", "iwildcam_template", ("IWildCamOOD",)),
             ("FMOWOOD", "fmow_template", ("FMOWOOD",)))
FMOW_REGIONS = ("Asia", "Europe", "Africa", "Americas", "Oceania", "Other")


def eval_png(seed: int, i: int, border: bool = False) -> bytes:
    arr = corpus_image(seed, i, high=401)
    if border:  # ObjectNet's red frame, which its loader crops away
        arr[:2], arr[-2:], arr[:, :2], arr[:, -2:] = (255, 0, 0), (255, 0, 0), (255, 0, 0), (255, 0, 0)
    return png_bytes(arr)


def write_eval_corpus(root: str, seed: int) -> dict:
    """The trees under ``root``; for each dataset, what its loader must
    yield in order (labels, and FMoW's regions), written down here and not
    read back through the package."""
    import csv

    from flyp_tpu_torch.data.classnames import IMAGENET_R_SUBLIST, fmow_classnames
    from flyp_tpu_torch.data.datasets.objectnet import get_metadata

    jobs, expected = imagenet_val_jobs(root)
    for c in IMAGENET_R_SUBLIST:
        jobs.append((os.path.join(root, "imagenet-r", f"n{c:05d}", "0.png"), False))
    expected["ImageNetR"] = {"labels": list(range(len(IMAGENET_R_SUBLIST))), "columns": sorted(IMAGENET_R_SUBLIST)}
    _, _, folder_to_ids, _ = get_metadata()
    folders = sorted(folder_to_ids)
    for folder in folders:
        for i in range(EVAL_OBJECTNET_PER_CLASS):
            jobs.append((os.path.join(root, "objectnet-1.0", "images", folder, f"{i}.png"), True))
    expected["ObjectNet"] = {"labels": [k for k in range(len(folders)) for _ in range(EVAL_OBJECTNET_PER_CLASS)],
                             "ids": [folder_to_ids[f] for f in folders]}

    wild = os.path.join(root, "iwildcam_v2.0")
    rows, labels = [], []
    r = 0
    while len(labels) < EVAL_WILDS_ROWS:
        split = ("train", "id_test", "id_val")[r // 8 % 3] if r % 8 == 7 else "test"  # others: left out
        y = (7 * r) % 60 if split == "test" else r % 182
        rows.append({"split": split, "filename": f"{r:06d}.png", "y": y, "image_id": f"id{r}", "location": r % 9})
        if split == "test":
            labels.append(y)
            jobs.append((os.path.join(wild, "train", f"{r:06d}.png"), False))
        r += 1
    os.makedirs(wild)
    with open(os.path.join(wild, "metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    expected["IWildCamOOD"] = {"labels": labels}

    fmow = os.path.join(root, "fmow_v1.1")
    rows, labels, regions = [], [], []
    r = 0
    while len(labels) < EVAL_WILDS_ROWS:
        year = 2016 + r % 3
        kind = r % 10
        split, stamp = "test", f"{year}-{1 + r % 12:02d}-{1 + r % 28:02d}T10:{r % 60:02d}:00Z"
        if kind == 7:
            split = "seq"  # dropped
        elif kind == 8:
            split, stamp = "test", f"2014-{1 + r % 12:02d}-03T00:00:00Z"  # OOD val's years: not OOD test
        elif kind == 9:
            split = ("train", "val")[r % 2]  # other splits
        elif kind == 3:
            stamp = f"{year}-{1 + r % 12:02d}-{1 + r % 28:02d} 08:30:00"  # another timestamp format
        category, region = fmow_classnames[(5 * r) % 62], FMOW_REGIONS[r % len(FMOW_REGIONS)]
        if split == "test" and year >= 2016 and kind != 8:
            labels.append(fmow_classnames.index(category))
            regions.append(region)
            jobs.append((os.path.join(fmow, "images", f"rgb_img_{r}.png"), False))
        rows.append({"split": split, "timestamp": stamp, "category": category, "region": region})
        r += 1
    os.makedirs(os.path.join(fmow, "images"))
    with open(os.path.join(fmow, "rgb_metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    expected["FMOWOOD"] = {"labels": labels, "regions": regions}

    write_pngs(jobs, seed)
    expected["images"] = len(jobs)
    return expected


def imagenet_val_jobs(root: str, per_class: int = EVAL_PER_CLASS):
    """ImageNet's val tree under ``root`` (1,000 class folders of
    ``per_class`` images): the PNG jobs and the labels in loader order."""
    val = os.path.join(root, "ILSVRC2012", "val")
    os.makedirs(os.path.join(root, "ILSVRC2012", "train"))
    jobs = [(os.path.join(val, f"n{c:05d}", f"{i}.png"), False) for c in range(1000) for i in range(per_class)]
    return jobs, {"ImageNet": {"labels": [c for c in range(1000) for _ in range(per_class)]}}


def write_pngs(jobs, seed: int) -> None:
    """Job n, ``(path, border)``, becomes ``eval_png(seed, n, border)`` at
    ``path``."""
    from concurrent.futures import ThreadPoolExecutor

    def write(job):
        n, (path, border) = job
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(eval_png(seed, n, border))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(write, enumerate(jobs)))


_TRAINER_CORPORA: dict = {}  # seed -> (TSV, data root, ImageNet val labels); removed when the process exits


def trainer_corpus(seed: int = 0) -> tuple:
    """(TSV, data root, ImageNet val labels, seconds spent writing): phase
    5b's corpus under ``<root>/train`` and ImageNet's val tree at
    ``EVAL_PER_CLASS`` PNGs a class, written on the first call into a
    directory removed when the process exits.  The phases that train from
    disk (10, 11 and 12) read these same seeded files, each from its own
    working root, so the files are written once (0.0 seconds after)."""
    import atexit
    import shutil

    if seed in _TRAINER_CORPORA:
        return (*_TRAINER_CORPORA[seed], 0.0)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="flyp_trainer_corpus_")
    atexit.register(shutil.rmtree, root, True)
    os.makedirs(os.path.join(root, "train"))
    tsv, _, _ = write_corpus(os.path.join(root, "train"), seed)
    jobs, expected = imagenet_val_jobs(root)
    write_pngs(jobs, seed)
    _TRAINER_CORPORA[seed] = (tsv, root, expected)
    return tsv, root, expected, time.perf_counter() - t0


def macro_f1_numpy(preds: np.ndarray, labels: np.ndarray) -> float:
    """WILDS's macro F1: the mean over the classes in the labels or the
    predictions of 2 tp / (2 tp + fp + fn)."""
    scores = []
    for c in np.union1d(labels, preds):
        tp = np.sum((preds == c) & (labels == c))
        denom = 2 * tp + np.sum((preds == c) & (labels != c)) + np.sum((preds != c) & (labels == c))
        scores.append(2 * tp / denom if tp else 0.0)
    return float(np.mean(scores))


def expected_stats(name: str, logits: np.ndarray, want: dict) -> dict:
    """``train_stats``' entries for ``name``, recomputed from the logits the
    harness saw and the labels the corpus was written with: top-1 (after
    ImageNet-R's 200-column projection, or ObjectNet's max over each
    class's ImageNet ids, which has no per-class rows), then each class's
    accuracy and count in ascending accuracy (ties in the order the
    classes first appear, batch by batch, in increasing id), then
    iWildCam's macro F1 or FMoW's worst named region."""
    labels = np.asarray(want["labels"])
    if name == "ObjectNet":
        pooled = np.stack([logits[:, ids].max(axis=1) for ids in want["ids"]], axis=1)
        return {f"{name} Accuracy": round(float((pooled.argmax(1) == labels).sum()) / len(labels), 4)}
    if name == "ImageNetR":
        logits = logits[:, want["columns"]]
    preds = logits.argmax(1)
    out = {f"{name} Accuracy": round(float((preds == labels).sum()) / len(labels), 4)}
    order = []
    for b in range(0, len(labels), EVAL_BATCH):
        order += [int(c) for c in sorted(set(labels[b:b + EVAL_BATCH].tolist())) if c not in order]
    acc = {c: (int((preds[labels == c] == c).sum()), int((labels == c).sum())) for c in order}
    for c in sorted(order, key=lambda c: acc[c][0] / acc[c][1]):
        out[f"{name} Class {c} Accuracy"] = round(acc[c][0] / acc[c][1], 4)
        out[f"{name} Class {c} Number"] = acc[c][1]
    if name == "IWildCamOOD":
        out[f"{name}F1-macro_all"] = round(macro_f1_numpy(preds, labels), 4)
    if name == "FMOWOOD":
        regions = np.asarray(want["regions"])
        out[f"{name}acc_worst_region"] = round(min(float((preds[regions == r] == labels[regions == r]).mean())
                                                   for r in FMOW_REGIONS if r != "Other"), 4)
    return out


def phase_evaluation(card: str, seed: int = 0) -> dict:
    """The evaluation harness at full ViT-B/16 width in bf16:
    ``cli/zeroshot_eval.main`` three times over the seeded corpus, B3's
    launches exact, every metric recomputed, the features and the head
    against the CPU, and the feature cache."""
    import io

    from flyp_tpu_torch.cli import zeroshot_eval
    from flyp_tpu_torch.config import parse_arguments
    from flyp_tpu_torch.data.classnames import openai_classnames
    from flyp_tpu_torch.data.datasets import ImageNet
    from flyp_tpu_torch.data.transforms import eval_transform
    from flyp_tpu_torch.evaluation import evaluator
    from flyp_tpu_torch.evaluation.features import get_features
    from flyp_tpu_torch.templates import get_template

    t_phase = time.perf_counter()
    px, layers_v, layers_t = model_shape()
    out = {}
    saw = {"rows": {}, "heads": {}, "seconds": {}, "current": None}

    class RecordingClassifier(Classifier):
        """``Classifier`` that keeps what the harness saw: each batch's
        device logits, its valid rows and its host images."""

        def predict_logits_device(self, images):
            logits, n = super().predict_logits_device(images)
            saw["rows"].setdefault(saw["current"], []).append((logits, n, images))
            return logits, n

    build_head, eval_one = zeroshot_eval.build_zeroshot_head, evaluator.eval_single_dataset

    def timed_head(cfg, model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        head = build_head(cfg, model)
        torch.cuda.synchronize()
        saw["heads"][cfg.train_dataset] = (head, model, time.perf_counter() - t0)
        return head

    def timed_eval(classifier, dataset, cfg, *args, **kwargs):
        saw["current"] = type(dataset).__name__
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eval_one(classifier, dataset, cfg, *args, **kwargs)
        torch.cuda.synchronize()
        saw["seconds"][saw["current"]] = time.perf_counter() - t0
        return res

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        expected = write_eval_corpus(root, seed)
        out["corpus_s"] = time.perf_counter() - t0
        cpu_model = build_clip_model(SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="float32", seed=0),
                                     device="cpu")
        ckpt = os.path.join(root, "vit_b16_random.pt")
        convert.save_torch_checkpoint(ckpt, convert.export_clip_state_dict(cpu_model.state_dict(),
                                                                           cpu_model.config))
        del cpu_model
        log(f"evaluation: corpus of {expected['images']} PNGs and a random-init {MODEL} .pt in "
            f"{time.perf_counter() - t0:.1f} s")

        stats, prompts, want_b3 = {}, {}, 0
        zeroshot_eval.Classifier, zeroshot_eval.build_zeroshot_head = RecordingClassifier, timed_head
        evaluator.eval_single_dataset = timed_eval
        try:
            reset_counts()
            # ---- the evaluation path: counts start at 0 here ----------------
            for train_dataset, template, names in EVAL_RUNS:
                cfg = parse_arguments(["--clip_load", ckpt, "--model", MODEL, "--train-dataset", train_dataset,
                                       "--template", template, "--eval-datasets", ",".join(names),
                                       "--data-location", root, "--batch-size", str(EVAL_BATCH),
                                       "--workers", str(EVAL_WORKERS), "--seed", str(seed)])
                cfg.log_dir = os.path.join(root, "logs", train_dataset)
                with contextlib.redirect_stdout(io.StringIO()):  # its log (every stats row) goes to log_dir
                    stats[train_dataset] = zeroshot_eval.main(cfg)
                prompts[train_dataset] = len(saw["heads"][train_dataset][0].weight) * len(get_template(template))
                want_b3 += layers_t * math.ceil(prompts[train_dataset] / min(1024, max(8, prompts[train_dataset])))
                want_b3 += layers_v * sum(math.ceil(len(expected[n]["labels"]) / EVAL_BATCH) for n in names)
            launches = counts()
            # ---- end of the evaluation path ---------------------------------
        finally:
            zeroshot_eval.Classifier, zeroshot_eval.build_zeroshot_head = Classifier, build_head
            evaluator.eval_single_dataset = eval_one
        expect_counts("the evaluation path (3 zero-shot runs)", B3=want_b3)
        out.update(launches=launches, prompts=prompts,
                   head_s={k: v[2] for k, v in saw["heads"].items()})
        log(f"evaluation: {launches['B3']} attention-block kernel launches, as expected; prompts {prompts}, head "
            f"build s {out['head_s']}")

        # Every metric, recomputed from the logits the harness saw.
        out["images"], out["eval_img_s"], out["top1"] = {}, {}, {}
        for train_dataset, _, names in EVAL_RUNS:
            want_stats = {}
            for name in names:
                rows = saw["rows"][name]
                logits = np.concatenate([t[:n].float().cpu().numpy() for t, n, _ in rows])
                if logits.shape[0] != len(expected[name]["labels"]) or not np.isfinite(logits).all():
                    raise AssertionError(f"{name}: {logits.shape} logits for {len(expected[name]['labels'])} images")
                want_stats.update(expected_stats(name, logits, expected[name]))
                out["images"][name] = logits.shape[0]
                out["eval_img_s"][name] = logits.shape[0] / saw["seconds"][name]
                out["top1"][name] = want_stats[f"{name} Accuracy"]
            got = stats[train_dataset]
            if list(got.items()) != list(want_stats.items()):
                diff = [k for k in set(got) | set(want_stats) if got.get(k) != want_stats.get(k)]
                raise AssertionError(f"{train_dataset} run: train_stats differ from the recomputation at "
                                     f"{sorted(diff)[:10]} (order equal: {list(got) == list(want_stats)})")
        out["stats_entries"] = {k: len(v) for k, v in stats.items()}
        log(f"evaluation: every train_stats entry equals the recomputation ({out['stats_entries']}); eval img/s "
            f"through the loader {out['eval_img_s']} on {card}")

        # The same batches, decoded already and on the card: device-only img/s.
        head, model, _ = saw["heads"]["ImageNet"]
        out["device_img_s"] = {}
        for name, rows in saw["rows"].items():
            batches = []
            for _, n, images in rows:
                x = torch.zeros((EVAL_BATCH, px, px, 3), dtype=torch.bfloat16)
                x[:n] = torch.from_numpy(images)
                batches.append(x.cuda())
            run_head = saw["heads"][next(t for t, _, ns in EVAL_RUNS if name in ns)][0]
            with torch.inference_mode():
                run_head(model.encode_image(batches[0]))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for x in batches:
                    run_head(model.encode_image(x))
                torch.cuda.synchronize()
            out["device_img_s"][name] = sum(n for _, n, _ in rows) / (time.perf_counter() - t0)
            del batches
        log(f"evaluation: device-only img/s (pre-decoded batches on the card) {out['device_img_s']}")

        # Features of 64 corpus images on the card against the CPU plain
        # forward of the same .pt; the head against the CPU plain head.
        sample = np.concatenate([images[:n] for _, n, images in saw["rows"]["ImageNet"]])[:EVAL_FEATURES]
        del saw["rows"]
        cpu_cfg = SimpleNamespace(model=MODEL, clip_load=ckpt, compute_dtype="float32", seed=0)
        cpu_model = build_clip_model(cpu_cfg, device="cpu")
        with torch.inference_mode():
            ref = cpu_model.encode_image(torch.from_numpy(sample)).numpy()
        card32 = build_clip_model(cpu_cfg, device="cuda")
        cos32 = cosine(Classifier(card32, head, batch_size=EVAL_FEATURES).features(sample), ref)
        cos16 = cosine(Classifier(model, head, batch_size=EVAL_FEATURES).features(sample), ref)
        del card32
        log(f"evaluation: {EVAL_FEATURES} corpus images' features against the CPU plain forward: fp32 "
            f"{cos32.min():.7f}, bf16 {cos16.min():.5f}")
        if cos32.min() < 0.9999 or cos16.min() < 0.99:
            raise AssertionError(f"eval features drift from the CPU plain forward: fp32 {cos32}, bf16 {cos16}")
        out.update(cos_fp32=float(cos32.min()), cos_bf16=float(cos16.min()),
                   head_cosine=zeroshot_head_cosine(head, classnames=openai_classnames[:EVAL_HEAD_CLASSES],
                                                    model=cpu_model))
        del cpu_model

        # The feature cache: a miss encodes (B3 in every vision block of
        # every batch), a hit launches nothing and returns equal arrays.
        ds = ImageNet(preprocess=eval_transform(px), location=root, batch_size=EVAL_BATCH, num_workers=EVAL_WORKERS)
        clf = Classifier(model, head, batch_size=EVAL_BATCH)
        cache = os.path.join(root, "features")
        reset_counts()
        miss = get_features(clf, ds, split="test", cache_dir=cache)
        expect_counts("get_features, a miss", B3=layers_v * math.ceil(len(expected["ImageNet"]["labels"]) / EVAL_BATCH))
        reset_counts()
        hit = get_features(clf, ds, split="test", cache_dir=cache)
        expect_counts("get_features, a hit", B3=0)
        if sorted(hit) != sorted(miss) or not all(np.array_equal(hit[k], miss[k]) for k in miss):
            raise AssertionError("the cached features differ from the encoded ones")
        if hit["features"].shape != (len(expected["ImageNet"]["labels"]), model.config.embed_dim):
            raise AssertionError(f"features {hit['features'].shape}")
        out["cache"] = {"rows": int(hit["features"].shape[0]), "hit_launches": 0}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"evaluation: the feature cache's hit launched nothing; phase took {out['phase_s']:.1f} s")
    return out


# The trainer phase (10): the 5b corpus (14 batches of 256 rows, guidance
# 100 and 50) and the ImageNet val tree of phase 9; run A trains 2 epochs
# uninterrupted through ``cli/main.py``, run B the same command stopped twice
# in mid-epoch (``--max_steps 7 --save_every_n_steps 5``, ``--max_steps 10``)
# and resumed to the end.  Then the checkpoint reloaded through
# ``cli/zeroshot_eval.py``, and 13 synthetic steps with and without --remat.
TRAINER_EPOCHS = 2
TRAINER_INTERRUPTS = (("--max_steps", "7", "--save_every_n_steps", "5"), ("--max_steps", "10"), ())
TRAINER_RETURNS = ("checkpoint_0_step_6", "checkpoint_1_step_2", "checkpoint_1")
REMAT_STEPS = 13


def checkpoint_equal(a: str, b: str, where: str) -> int:
    """Every tensor file and the meta of two checkpoint directories bit for
    bit; returns the bytes of ``a``."""
    from flyp_tpu_torch.utils import checkpoint

    for name in (checkpoint.PARAMS_FILE, checkpoint.OPT_FILE, checkpoint.STATS_FILE):
        ta, tb = checkpoint.load_tensors(a, name), checkpoint.load_tensors(b, name)
        bad = sorted(k for k in set(ta) | set(tb) if k not in ta or k not in tb or ta[k].dtype != tb[k].dtype
                     or not torch.equal(ta[k], tb[k]))
        if bad:
            raise AssertionError(f"{where}: {name} differs at {len(bad)} tensors, e.g. {bad[:5]}")
    if checkpoint.read_meta(a) != checkpoint.read_meta(b):
        raise AssertionError(f"{where}: meta.json differs: {checkpoint.read_meta(a)} vs {checkpoint.read_meta(b)}")
    return sum(os.path.getsize(os.path.join(a, f)) for f in os.listdir(a))


def remat_run(remat: bool, images, tokens) -> dict:
    """13 steps of the bench configuration with or without ``--remat``: the
    losses, the parameters after, memory held before the steps (model,
    moments, inputs and whatever the process still holds) and the peak
    during them, and ms a step."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    model = build_clip_model(SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="bfloat16", seed=0,
                                             remat=remat), device="cuda")
    opt = make_optimizer(warmup_cosine_lr(1e-5, 500, 10_000), weight_decay=0.1, moment_dtype="bfloat16")
    state, step = create_train_state(model, opt), make_train_step(model, opt)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for n in range(REMAT_STEPS):
        if n == 3:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, images, tokens)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {"losses": torch.stack(losses).cpu(), "params": [p.detach().cpu() for p in model.parameters()],
           "base_gib": base / 2 ** 30, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "ms_per_step": dt / (REMAT_STEPS - 3) * 1e3}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def phase_trainer(card: str, seed: int = 0) -> dict:
    """The FLYP trainer at full ViT-B/16 width through its command line:
    whole epochs (train, checkpoint, head, evaluation, stats.tsv) fed from
    disk, a run interrupted twice that resumes to the uninterrupted run's
    checkpoint bit for bit, the checkpoint reloaded, and --remat."""
    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.cli import zeroshot_eval
    from flyp_tpu_torch.training import flyp
    from flyp_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    px, layers_v, layers_t = model_shape()
    per_step = layers_v + layers_t
    steps = INPUT_BATCHES * TRAINER_EPOCHS
    out = {"card": card}
    marks = {"step": [], "save": [], "commit": [], "head": [], "eval": []}
    real = {"step": flyp.make_train_step, "save": flyp.save_checkpoint, "commit": checkpoint._write_checkpoint_dir,
            "head": flyp.build_zeroshot_head, "eval": flyp.evaluate}

    def timed(kind, fn, sync=True):
        def wrapper(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            marks[kind].append((t0, time.perf_counter(), args[0] if kind in ("save", "commit") else None))
            return res
        return wrapper

    def make_step(*args, **kwargs):
        step = real["step"](*args, **kwargs)

        def stamped(*a, **k):
            marks["step"].append((time.perf_counter(), None, None))
            return step(*a, **k)
        return stamped

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        tsv, data, expected, out["corpus_s"] = trainer_corpus(seed)
        log(f"trainer: corpus of {INPUT_BATCH * INPUT_BATCHES} TSV rows and {len(expected['ImageNet']['labels'])} "
            f"ImageNet val PNGs in {out['corpus_s']:.1f} s")
        argv = ["--ft_data", tsv, "--batch-size", str(INPUT_BATCH), "--data_backend", "native", "--workers",
                str(INPUT_WORKERS), "--model", MODEL, "--seed", str(seed), "--curriculum", "--epochs",
                str(TRAINER_EPOCHS), "--lr", "1e-5", "--warmup_length", "500", "--adam_moment_dtype", "bfloat16",
                "--train-dataset", "ImageNet", "--template", "openai_imagenet_template", "--eval-datasets",
                "ImageNet", "--data-location", data, "--save", os.path.join(root, "ckpt")]
        prompts = 1000 * 80
        head_b3 = layers_t * math.ceil(prompts / 1024)
        eval_b3 = layers_v * math.ceil(len(expected["ImageNet"]["labels"]) / INPUT_BATCH)
        runs, launches = {}, {}
        flyp.make_train_step, flyp.save_checkpoint = make_step, timed("save", real["save"])
        flyp.build_zeroshot_head, flyp.evaluate = timed("head", real["head"]), timed("eval", real["eval"])
        checkpoint._write_checkpoint_dir = timed("commit", real["commit"], sync=False)
        os.chdir(root)  # cli/main.py writes expt_logs/ under the working directory
        try:
            for name, interrupts in (("a", ((),)), ("b", TRAINER_INTERRUPTS)):
                reset_counts()
                # ---- the trainer path: counts start at 0 here -----------------
                t0 = time.perf_counter()
                returned = [cli_main.main(cli_main.parse_main_arguments([*argv, "--exp_name", f"trainer_{name}",
                                                                         *extra]))
                            for extra in interrupts]
                launches[name] = counts()
                # ---- end of the trainer path ----------------------------------
                runs[name] = {"returned": [os.path.basename(p) for p in returned], "s": time.perf_counter() - t0,
                              "save": os.path.dirname(returned[-1]),
                              "log": os.path.join(root, "expt_logs", f"trainer_{name}",
                                                  os.path.basename(os.path.dirname(returned[-1])))}
                expect_counts(f"trainer run {name}", B1=steps * per_step, B2=steps * per_step,
                              B3=TRAINER_EPOCHS * (head_b3 + eval_b3))
        finally:
            os.chdir(cwd)
            flyp.make_train_step, flyp.save_checkpoint = real["step"], real["save"]
            flyp.build_zeroshot_head, flyp.evaluate = real["head"], real["eval"]
            checkpoint._write_checkpoint_dir = real["commit"]
        if runs["b"]["returned"] != list(TRAINER_RETURNS) or runs["a"]["returned"] != ["checkpoint_1"]:
            raise AssertionError(f"the runs returned {runs['a']['returned']} and {runs['b']['returned']}")
        out.update(launches=launches, runs_s={k: v["s"] for k, v in runs.items()})
        log(f"trainer: run A {runs['a']['s']:.1f} s, run B (3 invocations) {runs['b']['s']:.1f} s; launches "
            f"{launches}, as predicted")

        # Run A's epochs: train (first step to the save; epoch 1 from the end
        # of epoch 0's evaluation), the save's blocking part, its commit,
        # the head, the evaluation.
        n_a = steps
        step_t = [t for t, _, _ in marks["step"][:n_a]]
        saves = [(t0, t1) for t0, t1, p in marks["save"] if "trainer_a" in p and "_step_" not in p]
        commits = [(t0, t1) for t0, t1, p in marks["commit"] if "trainer_a" in p and "_step_" not in p]
        heads, evals = marks["head"][:TRAINER_EPOCHS], marks["eval"][:TRAINER_EPOCHS]
        epochs = []
        for e in range(TRAINER_EPOCHS):
            start = step_t[e * INPUT_BATCHES] if e == 0 else evals[e - 1][1]
            epochs.append({"train_s": saves[e][0] - start, "save_blocking_s": saves[e][1] - saves[e][0],
                           "commit_s": commits[e][1] - commits[e][0], "head_s": heads[e][1] - heads[e][0],
                           "eval_s": evals[e][1] - evals[e][0]})
        out["epochs"] = epochs
        out["fed_img_s"] = INPUT_BATCHES * INPUT_BATCH / epochs[-1]["train_s"]
        out["eval_img_s"] = len(expected["ImageNet"]["labels"]) / epochs[-1]["eval_s"]
        log(f"trainer: run A by epoch {epochs}; epoch {TRAINER_EPOCHS - 1} fed at {out['fed_img_s']:.2f} img/s, "
            f"evaluated at {out['eval_img_s']:.2f} img/s on {card}")

        # Held exactly: A's and B's checkpoints and stats.tsv.
        for e in range(TRAINER_EPOCHS):
            out["checkpoint_bytes"] = checkpoint_equal(os.path.join(runs["a"]["save"], f"checkpoint_{e}"),
                                                       os.path.join(runs["b"]["save"], f"checkpoint_{e}"),
                                                       f"checkpoint_{e} of runs A and B")
        with open(os.path.join(runs["a"]["log"], "stats.tsv")) as f:
            stats_a = f.read()
        with open(os.path.join(runs["b"]["log"], "stats.tsv")) as f:
            stats_b = f.read()
        if stats_a != stats_b:
            raise AssertionError(f"stats.tsv of runs A and B differ:\n{stats_a}\n{stats_b}")
        rows = [line.split("\t") for line in stats_a.rstrip("\n").split("\n")]
        stats = [dict(zip(rows[0][1:], r[1:])) for r in rows[1:]]
        if len(stats) != TRAINER_EPOCHS or not all(math.isfinite(float(r["Avg ID FLYP Loss"])) for r in stats):
            raise AssertionError(f"stats.tsv of run A: {stats}")
        out["stats"] = stats
        log(f"trainer: checkpoint_0 and checkpoint_1 ({out['checkpoint_bytes']} bytes) of runs A and B bit-equal, "
            f"params and moments; stats.tsv equal: {stats}")

        # The checkpoint reloaded as a user evaluates it, with the head saved.
        saw = {}
        build_head = zeroshot_eval.build_zeroshot_head

        def keep_head(cfg, model):
            saw["head"] = build_head(cfg, model)
            return saw["head"]

        zeroshot_eval.build_zeroshot_head = keep_head
        reset_counts()
        try:
            cfg = cli_main.parse_main_arguments([
                "--clip_load", os.path.join(runs["a"]["save"], f"checkpoint_{TRAINER_EPOCHS - 1}"), "--model", MODEL,
                "--train-dataset", "ImageNet", "--template", "openai_imagenet_template", "--eval-datasets", "ImageNet",
                "--data-location", data, "--batch-size", str(INPUT_BATCH), "--workers", str(INPUT_WORKERS),
                "--save", os.path.join(root, "head")])
            cfg.log_dir = os.path.join(root, "logs", "zeroshot")
            import io

            with contextlib.redirect_stdout(io.StringIO()):
                reloaded = zeroshot_eval.main(cfg)
        finally:
            zeroshot_eval.build_zeroshot_head = build_head
        expect_counts("the reloaded checkpoint's head and evaluation", B3=head_b3 + eval_b3)
        logged = float(stats[-1]["ImageNet Accuracy"])
        if reloaded["ImageNet Accuracy"] != logged:
            raise AssertionError(f"the reloaded checkpoint's top-1 {reloaded['ImageNet Accuracy']} differs from the "
                                 f"trainer's logged {logged}")
        head = checkpoint.restore_params(os.path.join(root, "head", "zeroshot_head"))
        if sorted(head) != ["bias", "weight"] or not all(
                torch.equal(head[k], getattr(saw["head"], k).detach().cpu()) for k in head):
            raise AssertionError("the saved zero-shot head differs from the one evaluated")
        out.update(reloaded_top1=reloaded["ImageNet Accuracy"], head_shape=list(head["weight"].shape))
        log(f"trainer: checkpoint_1 reloaded through zeroshot_eval gives top-1 {logged}, the logged value; its saved "
            f"head {list(head['weight'].shape)} reads back bit-equal")

    # --remat: 13 synthetic steps, losses and parameters bit-equal, less memory.
    images, tokens = bench_batch(INPUT_BATCH, px, seed=0)
    images, tokens = torch.from_numpy(images).to(torch.bfloat16).cuda(), torch.from_numpy(tokens).cuda()
    plain, remat = remat_run(False, images, tokens), remat_run(True, images, tokens)
    if not torch.equal(plain["losses"], remat["losses"]):
        raise AssertionError(f"--remat changes the losses: {plain['losses'].tolist()} vs {remat['losses'].tolist()}")
    if not all(torch.equal(a, b) for a, b in zip(plain["params"], remat["params"])):
        raise AssertionError("--remat changes the parameters after 13 steps")
    if not remat["peak_gib"] < plain["peak_gib"]:
        raise AssertionError(f"--remat does not lower the peak: {remat['peak_gib']} vs {plain['peak_gib']} GiB")
    out["remat"] = {k: {n: r[n] for n in ("base_gib", "peak_gib", "ms_per_step")}
                    for k, r in (("off", plain), ("on", remat))}
    out["remat"]["losses"] = plain["losses"].tolist()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"trainer: --remat: losses and parameters bit-equal over {REMAT_STEPS} steps; peak {plain['peak_gib']:.3f} "
        f"-> {remat['peak_gib']:.3f} GiB (held before the steps {plain['base_gib']:.3f}, {remat['base_gib']:.3f}), "
        f"{plain['ms_per_step']:.2f} -> {remat['ms_per_step']:.2f} ms/step; phase took {out['phase_s']:.1f} s on "
        f"{card}")
    return out


# Phase 11: the ModifiedResNet towers (RN50: BatchNorm state) and the chunked
# (GradCache) step, on the default route.
RN_MODEL = "RN50"
RN_CHUNKS = 2  # the chunked RN50 step: 256 = 2 x 128
VIT_CHUNKED = (512, 4)  # the chunked ViT-B/16 step: 512 = 4 x 128
VIT_CHUNKED_STEPS = 5  # timed, after one untimed
RN_TRAINER_INTERRUPTS = (("--max_steps", "5", "--save_every_n_steps", "3"), ())
RN_TRAINER_RETURNS = ("checkpoint_0_step_4", "checkpoint_0")
RN_SERVE_BATCH = 256
RN_BF16_LOSS = 2e-2  # the bf16 RN50 step's loss against the CPU fp32 step (phase 5's bound)


class GradCapture:
    """An optimizer that keeps a step's gradients (fp32, on the device) and
    updates nothing: how a step's gradients are read beside an oracle's."""

    def init(self, params):
        from flyp_tpu_torch.training.train_state import AdamWState

        return AdamWState(count=torch.zeros((), dtype=torch.int32, device=next(iter(params)).device), mu=[], nu=[])

    def update(self, params, grads, state, frozen=None):
        self.grads = [g.detach().float().clone() for g in grads]
        return torch.zeros((), device=state.count.device)


def rn_cfg(dtype: str, model: str = RN_MODEL) -> SimpleNamespace:
    return SimpleNamespace(model=model, clip_load=None, compute_dtype=dtype, seed=0)


def stats_of(model) -> dict:
    """A host copy of the running statistics (a copy on the CPU too, where
    the next train-mode forward updates the buffers in place)."""
    return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in model.named_buffers()}


def stats_rel_err(stats, ref) -> float:
    """The largest ||a - b|| / ||b|| over the running statistics."""
    return max(float((stats[k] - v).norm() / v.norm()) for k, v in ref.items())


def stats_moved(stats, before) -> float:
    """The largest change of a running statistic."""
    return max(float((stats[k] - v).abs().max()) for k, v in before.items())


# The attention pool's k bias has an exact gradient of 0 (a constant added to
# every key leaves the softmax unchanged): its cosine is a ratio of rounding
# noise, so it is held to a norm below 1e-5 of the largest gradient instead.
ZERO_GRADS = ("visual.attnpool.k_proj.bias",)


def grad_report(grads, ref, names, min_cos: float, where: str, select=None) -> dict:
    """Per-tensor cosines of two gradient lists over the parameters that
    ``select(name)`` keeps (all by default); raises below ``min_cos``."""
    grads, ref = [g.cpu() for g in grads], [g.cpu() for g in ref]
    largest = max(float(g.norm()) for g in ref)
    keep = [i for i, n in enumerate(names) if n not in ZERO_GRADS and (select is None or select(n))]
    for i, n in enumerate(names):
        if n in ZERO_GRADS and max(float(grads[i].norm()), float(ref[i].norm())) > 1e-5 * largest:
            raise AssertionError(f"{where}: {n}'s gradient is not ~0: {grads[i].norm()}, {ref[i].norm()}")
    cos = grad_cosines([grads[i] for i in keep], [ref[i] for i in keep])
    rel = max(float((grads[i] - ref[i]).norm() / ref[i].norm()) for i in keep if float(ref[i].norm()) > 0)
    if min(cos) < min_cos:
        raise AssertionError(f"{where}: gradients drift, worst {sorted(zip(cos, [names[i] for i in keep]))[:5]}")
    return {"min_grad_cosine": min(cos), "max_grad_rel_err": rel}


# The fp32 card step may differ from the CPU's by SPREAD_FACTOR times the
# CPU's own spread (the same step at one thread against all threads).
SPREAD_FACTOR = 4


def rn_step_check(images, tokens) -> dict:
    """One RN50 step's loss, gradients and updated running statistics at
    B=4, full width, the card against the CPU plain step (all threads).

    A random-init BatchNorm ResNet in training mode amplifies rounding:
    batch statistics couple the images (Yang et al. 2019, "A Mean Field
    Theory of Batch Normalization"), and a ReLU after a BatchNorm whose
    channel is nearly constant over the batch masks outputs of rounding
    size, so the order of an fp32 sum alone moves the image tower's
    gradients.
    fp32 is therefore held to the CPU's own spread, the same step at one
    thread against all threads: least gradient cosine at least 1 -
    SPREAD_FACTOR (1 - the spread's), loss within SPREAD_FACTOR times the
    spread's rel err (each no tighter than phase 5's 0.9999 and 1e-4),
    running statistics within 1e-4.  In bf16 a rounding is 2**16 times an
    fp32 one: the image features move far more and, through the loss,
    every gradient with them, so bf16 is held to the loss alone
    (RN_BF16_LOSS, phase 5's bound) and its cosines and statistics are
    recorded.  The bf16 tower is held where it is not chaotic: in eval mode
    (the serving check) and against the chunked step's oracle, which runs
    the same kernels."""
    out = {}
    threads = torch.get_num_threads()
    refs = {}
    for n in (threads, 1):
        t0 = time.perf_counter()
        torch.set_num_threads(n)
        cpu = build_clip_model(rn_cfg("float32"), device="cpu").train().requires_grad_(True)
        refs[n] = (*loss_and_grads(cpu, torch.from_numpy(images), torch.from_numpy(tokens)), stats_of(cpu))
        log(f"resnet: CPU plain {RN_MODEL} step, fp32, B=4, {n} threads: loss {refs[n][0]:.7f} in "
            f"{time.perf_counter() - t0:.1f} s")
    torch.set_num_threads(threads)
    names = [n for n, _ in cpu.named_parameters()]
    del cpu
    ref_loss, ref_grads, ref_stats = refs[threads]
    spread = grad_report(refs[1][1], ref_grads, names, -1.0, "the CPU's own spread")
    spread["loss_rel_err"] = abs(refs[1][0] - ref_loss) / abs(ref_loss)
    out["cpu_spread"] = spread
    bounds = {"float32": (min(0.9999, 1 - SPREAD_FACTOR * (1 - spread["min_grad_cosine"])),
                          max(1e-4, SPREAD_FACTOR * spread["loss_rel_err"]), 1e-4),
              "bfloat16": (-1.0, RN_BF16_LOSS, math.inf)}
    for name, (min_cos, loss_tol, stats_tol) in bounds.items():
        model = build_clip_model(rn_cfg(name), device="cuda").train().requires_grad_(True)
        before = stats_of(model)
        loss, grads = loss_and_grads(model, torch.from_numpy(images).cuda(), torch.from_numpy(tokens).cuda())
        rel = abs(loss - ref_loss) / abs(ref_loss)
        where = f"{RN_MODEL} {name} step against the CPU"
        rep = grad_report(grads, ref_grads, names, min_cos, where)
        if name != "float32":
            rep["text_min_grad_cosine"] = grad_report(grads, ref_grads, names, -1.0, where,
                                                      select=lambda n: not n.startswith("visual."))["min_grad_cosine"]
        stats_err = stats_rel_err(stats_of(model), ref_stats)
        moved = stats_moved(stats_of(model), before)
        log(f"resnet: card {RN_MODEL} step, {name}, B=4: loss {loss:.7f} (rel err {rel:.3g}, bound {loss_tol:.3g}), "
            f"min grad cosine {rep['min_grad_cosine']:.7f} (bound {min_cos:.7f}), running statistics rel err "
            f"{stats_err:.3g} (moved {moved:.3g}); the CPU's own spread: min cosine {spread['min_grad_cosine']:.7f}, "
            f"loss rel err {spread['loss_rel_err']:.3g}"
            + (f"; text tower and scale min cosine {rep['text_min_grad_cosine']:.4f}" if name != "float32" else ""))
        if rel > loss_tol or stats_err > stats_tol or not math.isfinite(stats_err) or moved == 0.0:
            raise AssertionError(f"{RN_MODEL} {name} step drifts from the CPU plain step: loss rel err {rel}, "
                                 f"statistics rel err {stats_err}, moved {moved}")
        out[name] = {"loss_rel_err": rel, **rep, "stats_rel_err": stats_err, "bounds": [min_cos, loss_tol]}
        del model, grads
    return out


def rn_chunked_check(images, tokens, layers_t: int) -> dict:
    """The chunked RN50 step (256 = 2 x 128, bf16) against the chunk-wise
    oracle on the card: per-chunk forwards under autograd (the running
    statistics chained), concatenated, one loss, one backward."""
    model = build_clip_model(rn_cfg("bfloat16"), device="cuda")
    oracle = build_clip_model(rn_cfg("bfloat16"), device="cuda").train().requires_grad_(True)
    cap = GradCapture()
    state = create_train_state(model, cap)
    step = make_train_step(model, cap, grad_cache_chunks=RN_CHUNKS)
    reset_counts()
    # ---- the chunked RN50 step: counts start at 0 here ----------------------
    state, metrics = step(state, images, tokens)
    loss = float(metrics["loss"])
    # ---- end of the chunked step --------------------------------------------
    expect_counts("the chunked RN50 step", B1=layers_t * RN_CHUNKS * 2, B2=layers_t * RN_CHUNKS)
    m = images.shape[0] // RN_CHUNKS
    feats = [oracle(images[i:i + m], tokens[i:i + m]) for i in range(0, images.shape[0], m)]
    ref = clip_loss(torch.cat([f[0] for f in feats]), torch.cat([f[1] for f in feats]), feats[0][2]).mean()
    ref_grads = torch.autograd.grad(ref, list(oracle.parameters()))
    names = [n for n, _ in model.named_parameters()]
    rel = abs(loss - ref.item()) / abs(ref.item())
    rep = grad_report(cap.grads, [g.float() for g in ref_grads], names, 0.9999, "the chunked RN50 step")
    stats, ref_stats = stats_of(model), stats_of(oracle)
    stats_err = stats_rel_err(stats, ref_stats)
    equal = all(torch.equal(stats[k], v) for k, v in ref_stats.items())
    log(f"resnet: chunked {RN_MODEL} step ({RN_CHUNKS} x {m}, bf16) against the chunk-wise oracle: loss {loss:.7f} "
        f"(rel err {rel:.3g}), min grad cosine {rep['min_grad_cosine']:.7f}, chained running statistics rel err "
        f"{stats_err:.3g} (bit-equal: {equal})")
    if rel > 1e-5 or stats_err > 1e-6:
        raise AssertionError(f"the chunked RN50 step differs from its oracle: loss rel err {rel}, statistics {stats_err}")
    return {"loss": loss, "loss_rel_err": rel, **rep, "stats_rel_err": stats_err, "stats_bit_equal": equal}


def vit_chunked(card: str) -> dict:
    """The chunked ViT-B/16 step at batch 512 = 4 x 128 (bf16, bf16 moments,
    the default route) against the direct step at 512: the loss and the
    gradients of one step from one state, the launches exactly, ms a step
    and peak memory over 1 + VIT_CHUNKED_STEPS steps each."""
    import gc

    B, n_chunks = VIT_CHUNKED
    model = build_clip_model(rn_cfg("bfloat16", MODEL), device="cuda")
    blocks = model.config.vision.layers + model.config.text.layers
    images, tokens = bench_batch(B, model.config.vision.image_size, seed=0)
    images, tokens = torch.from_numpy(images).to(torch.bfloat16).cuda(), torch.from_numpy(tokens).cuda()
    launches = {"chunked": {"B1": blocks * 2 * n_chunks, "B2": blocks * n_chunks}, "direct": {"B1": blocks, "B2": blocks}}
    out, grads, losses = {}, {}, {}
    for name, c in (("chunked", n_chunks), ("direct", 1)):
        cap = GradCapture()
        reset_counts()
        _, metrics = make_train_step(model, cap, grad_cache_chunks=c)(create_train_state(model, cap), images, tokens)
        expect_counts(f"one {name} ViT-B/16 step at {B}", **launches[name])
        losses[name], grads[name] = float(metrics["loss"]), cap.grads
        del cap, metrics
    names = [n for n, _ in model.named_parameters()]
    rel = abs(losses["chunked"] - losses["direct"]) / abs(losses["direct"])
    out.update(loss=losses, loss_rel_err=rel,
               **grad_report(grads["chunked"], grads["direct"], names, 0.99, "the chunked ViT-B/16 step"))
    if rel > 2e-3:
        raise AssertionError(f"the chunked ViT-B/16 step's loss {losses} differs from the direct step's")
    del grads
    for name, c in (("chunked", n_chunks), ("direct", 1)):
        gc.collect()
        torch.cuda.empty_cache()
        opt = make_optimizer(warmup_cosine_lr(1e-5, 500, 10_000), weight_decay=0.1, moment_dtype="bfloat16")
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, grad_cache_chunks=c)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        # ---- the chunked (or direct) ViT-B/16 step at 512: counts from 0 ----
        for n in range(1 + VIT_CHUNKED_STEPS):
            if n == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = step(state, images, tokens)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / VIT_CHUNKED_STEPS
        # ---- end of the timed steps -----------------------------------------
        expect_counts(f"{1 + VIT_CHUNKED_STEPS} {name} ViT-B/16 steps at {B}",
                      **{k: (1 + VIT_CHUNKED_STEPS) * v for k, v in launches[name].items()})
        out[name] = {"ms_per_step": dt * 1e3, "img_s": B / dt, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "base_gib": base / 2 ** 30, "launches_per_step": launches[name],
                     "last_loss": float(metrics["loss"])}
        log(f"resnet: {name} ViT-B/16 step at {B} ({c} x {B // c}), bf16: {dt * 1e3:.2f} ms/step ({B / dt:.1f} img/s), "
            f"peak {out[name]['peak_gib']:.2f} GiB (held before {base / 2 ** 30:.2f}) on {card}")
        del state, step, opt
    if not out["chunked"]["peak_gib"] < out["direct"]["peak_gib"]:
        raise AssertionError(f"the chunked step's peak {out['chunked']['peak_gib']} GiB is not below the direct "
                             f"step's {out['direct']['peak_gib']}")
    log(f"resnet: chunked ViT-B/16 at {B}: loss rel err {rel:.3g} to the direct step, min grad cosine "
        f"{out['min_grad_cosine']:.6f}; launches per step {launches}")
    return out


def rn_trainer(card: str, layers_t: int, seed: int = 0) -> dict:
    """The RN50 trainer through ``cli/main.py``: phase 5b's corpus, one
    epoch with ``--grad_cache_chunks 2`` and the ImageNet evaluation on
    phase 9's val tree; the same command stopped by ``--max_steps 5
    --save_every_n_steps 3`` and resumed to the end; the checkpoints
    bit-equal (params, moments, running statistics, meta); the checkpoint
    reloaded through ``cli/zeroshot_eval``."""
    import io

    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.cli import zeroshot_eval
    from flyp_tpu_torch.utils import checkpoint

    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        tsv, data, _, out["corpus_s"] = trainer_corpus(seed)
        argv = ["--ft_data", tsv, "--batch-size", str(INPUT_BATCH), "--data_backend", "native", "--workers",
                str(INPUT_WORKERS), "--model", RN_MODEL, "--seed", str(seed), "--curriculum", "--epochs", "1",
                "--lr", "1e-5", "--warmup_length", "500", "--adam_moment_dtype", "bfloat16", "--grad_cache_chunks",
                str(RN_CHUNKS), "--train-dataset", "ImageNet", "--template", "openai_imagenet_template",
                "--eval-datasets", "ImageNet", "--data-location", data, "--save", os.path.join(root, "ckpt")]
        head_b3 = layers_t * math.ceil(1000 * 80 / 1024)  # the image tower has no attention blocks
        per_step = {"B1": layers_t * RN_CHUNKS * 2, "B2": layers_t * RN_CHUNKS}
        runs, launches = {}, {}
        os.chdir(root)  # cli/main.py writes expt_logs/ under the working directory
        try:
            for name, interrupts in (("a", ((),)), ("b", RN_TRAINER_INTERRUPTS)):
                reset_counts()
                # ---- the RN50 trainer path: counts start at 0 here ---------------
                t0 = time.perf_counter()
                returned = [cli_main.main(cli_main.parse_main_arguments([*argv, "--exp_name", f"rn_{name}", *extra]))
                            for extra in interrupts]
                launches[name] = counts()
                # ---- end of the trainer path -------------------------------------
                runs[name] = {"returned": [os.path.basename(p) for p in returned], "s": time.perf_counter() - t0,
                              "save": os.path.dirname(returned[-1]),
                              "log": os.path.join(root, "expt_logs", f"rn_{name}",
                                                  os.path.basename(os.path.dirname(returned[-1])))}
                expect_counts(f"RN50 trainer run {name}", B3=head_b3,
                              **{k: INPUT_BATCHES * v for k, v in per_step.items()})
        finally:
            os.chdir(cwd)
        if runs["b"]["returned"] != list(RN_TRAINER_RETURNS) or runs["a"]["returned"] != ["checkpoint_0"]:
            raise AssertionError(f"the RN50 runs returned {runs['a']['returned']} and {runs['b']['returned']}")
        a, b = (os.path.join(runs[k]["save"], "checkpoint_0") for k in ("a", "b"))
        out["checkpoint_bytes"] = checkpoint_equal(a, b, "checkpoint_0 of the RN50 runs A and B")
        stats = checkpoint.load_tensors(a, checkpoint.STATS_FILE)
        fresh = stats_of(build_clip_model(rn_cfg("float32"), device="cpu"))
        if sorted(stats) != sorted(fresh) or stats_moved(stats, fresh) == 0.0:
            raise AssertionError("checkpoint_0's batch_stats.pt does not hold trained running statistics")
        with open(os.path.join(runs["a"]["log"], "stats.tsv")) as f:
            rows = [line.split("\t") for line in f.read().rstrip("\n").split("\n")]
        logged = dict(zip(rows[0][1:], rows[1][1:]))
        out.update(launches=launches, runs_s={k: v["s"] for k, v in runs.items()}, stats=logged,
                   stats_tensors=len(stats))
        log(f"resnet: trainer run A {runs['a']['s']:.1f} s, run B (2 invocations) {runs['b']['s']:.1f} s; launches "
            f"{launches}, as predicted; checkpoint_0 ({out['checkpoint_bytes']} bytes, {len(stats)} running "
            f"statistics) of runs A and B bit-equal; stats.tsv {logged} on {card}")

        reset_counts()
        cfg = cli_main.parse_main_arguments([
            "--clip_load", a, "--model", RN_MODEL, "--train-dataset", "ImageNet", "--template",
            "openai_imagenet_template", "--eval-datasets", "ImageNet", "--data-location", data, "--batch-size",
            str(INPUT_BATCH), "--workers", str(INPUT_WORKERS)])
        cfg.log_dir = os.path.join(root, "logs", "zeroshot")
        with contextlib.redirect_stdout(io.StringIO()):
            reloaded = zeroshot_eval.main(cfg)
        expect_counts("the reloaded RN50 checkpoint's head and evaluation", B3=head_b3)
        if reloaded["ImageNet Accuracy"] != float(logged["ImageNet Accuracy"]):
            raise AssertionError(f"the reloaded RN50 checkpoint's top-1 {reloaded['ImageNet Accuracy']} differs from "
                                 f"the logged {logged['ImageNet Accuracy']}")
        out["reloaded_top1"] = reloaded["ImageNet Accuracy"]
        log(f"resnet: checkpoint_0 reloaded through zeroshot_eval gives top-1 {out['reloaded_top1']}, the logged value")
    return out


def rn_serving(tmp: str, card: str, layers_t: int) -> dict:
    """``ClipServer.from_checkpoint`` on an RN50 ``.pt`` written by the
    port's converter, with running statistics moved by train-mode forwards:
    a 256-image ``classify`` with B3 exact (the head only: the image tower
    has no attention blocks), features against the CPU plain forward."""
    cpu_model = build_clip_model(rn_cfg("float32"), device="cpu")
    px = cpu_model.config.vision.image_size
    rng = np.random.default_rng(3)
    with torch.no_grad():
        cpu_model.train()
        for _ in range(2):
            cpu_model.encode_image(torch.from_numpy(rng.standard_normal((8, px, px, 3)).astype(np.float32)))
        cpu_model.eval()
    ckpt = os.path.join(tmp, "rn50_random.pt")
    convert.save_torch_checkpoint(ckpt, convert.export_clip_state_dict(cpu_model.state_dict(), cpu_model.config))
    images = rng.standard_normal((RN_SERVE_BATCH, px, px, 3)).astype(np.float32)
    reset_counts()
    # ---- the RN50 serving path: counts start at 0 here ----------------------
    srv = ClipServer.from_checkpoint(ckpt, model=RN_MODEL, classnames=CLASSNAMES, template=simple_template,
                                     compute_dtype="bfloat16", device="cuda", image_buckets=BUCKETS)
    logits = srv.classify(images)
    # ---- end of the serving path --------------------------------------------
    expect_counts("RN50 serving", B3=layers_t)
    if logits.shape != (RN_SERVE_BATCH, len(CLASSNAMES)) or not np.isfinite(logits).all():
        raise AssertionError(f"RN50 classify: logits {logits.shape}")
    stats = {k: v for k, v in srv.model.named_buffers()}
    if not all(torch.equal(stats[k].cpu(), v) for k, v in cpu_model.named_buffers()):
        raise AssertionError("the server does not hold the checkpoint's running statistics")
    few = images[:16]
    with torch.inference_mode():
        ref = cpu_model.encode_image(torch.from_numpy(few), normalize=True).numpy()
    fp32_srv = ClipServer.from_checkpoint(ckpt, model=RN_MODEL, compute_dtype="float32", device="cuda",
                                          image_buckets=BUCKETS)
    cos32, cos16 = cosine(fp32_srv.encode_images(few), ref), cosine(srv.encode_images(few), ref)
    log(f"resnet: {RN_MODEL} server features against the CPU plain forward: fp32 {cos32.min():.7f}, "
        f"bf16 {cos16.min():.5f}")
    if cos32.min() < 0.9999 or cos16.min() < 0.99:
        raise AssertionError(f"RN50 server features drift from the CPU: fp32 {cos32}, bf16 {cos16}")
    del fp32_srv
    srv.classify(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        srv.classify(images)
    img_s = 5 * RN_SERVE_BATCH / (time.perf_counter() - t0)
    log(f"resnet: {RN_MODEL} classify, bucket {RN_SERVE_BATCH}, bf16: {img_s:.1f} img/s on {card}")
    return {"cos_fp32": float(cos32.min()), "cos_bf16": float(cos16.min()), "img_s": img_s, "launches": {"B3": layers_t}}


def phase_resnet(card: str) -> dict:
    """Phase 11: RN50 at full width (one step against the CPU in fp32 and
    bf16; the bench configuration with launches exact, the statistics
    moving and the loss falling), the chunked RN50 step against its oracle,
    the chunked ViT-B/16 step at 512 against the direct step, the RN50
    trainer stopped and resumed bit for bit, and the RN50 server."""
    t_phase = time.perf_counter()
    c = MODEL_CONFIGS[RN_MODEL]
    px, layers_t = c.vision.image_size, c.text.layers
    out = {"card": card}
    images, tokens = bench_batch(4, px, seed=1)
    out["step_check"] = rn_step_check(images, tokens)

    model = build_clip_model(rn_cfg("bfloat16"), device="cuda")
    before = stats_of(model)
    state, step, images, tokens, res = bench_training(model, "pallas_block", card)
    moved = stats_moved(stats_of(model), before)
    fast = make_optimizer(warmup_cosine_lr(1e-4, 1, 10_000), weight_decay=0.1, moment_dtype="bfloat16")
    fast_state, fast_step = create_train_state(model, fast), make_train_step(model, fast)
    losses = [float(fast_step(fast_state, images[:64], tokens[:64])[1]["loss"]) for _ in range(8)]
    log(f"resnet: learning check, 8 steps at 1e-4 on one batch of 64: {[round(v, 5) for v in losses]}; the bench "
        f"moved the running statistics by {moved:.3g}")
    if moved == 0.0 or not losses[-1] < losses[0]:
        raise AssertionError(f"RN50 training: statistics moved {moved}, losses {losses}")
    out["bench"] = {**res, "stats_moved": moved, "learning_losses": losses}
    del model, state, step, fast_state, fast_step

    out["chunked_rn"] = rn_chunked_check(images, tokens, layers_t)
    out["chunked_vit"] = vit_chunked(card)
    with cut_depth(RN_MODEL, **RN_TRAINER_DEPTH) as cut:
        out["trainer"] = rn_trainer(card, cut.text.layers)
    with tempfile.TemporaryDirectory() as tmp:
        out["serving"] = rn_serving(tmp, card, layers_t)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"resnet: phase took {out['phase_s']:.1f} s on {card}")
    return out


# B4, B5 and B6 at the training main path's shapes (batch 256 in bf16 at
# vision L=197 and text L=32), at B=64 in fp32 and bf16 (vision L=197, text
# L=77); B5 and B6 also at ViT-L/14@336px's L=577 and at their limit 1024.
IMPL_SHAPES = [(64, 197, 768, 12, False, BOTH), (64, 77, 512, 8, True, BOTH),
               (256, 197, 768, 12, False, (torch.bfloat16,)), (256, 32, 512, 8, True, (torch.bfloat16,))]
LONG_SHAPES = [(8, 577, 1024, 16, False, BOTH), (4, 1024, 768, 12, False, BOTH)]


def attention_bound_ms(B, L, D, causal, dtype, peaks, backward: bool):
    """(ms, "operations" | "bytes") for one B5/B6 call.  FLOPs: 4BL^2D
    forward, 10BL^2D backward (halved by the causal mask); bytes: q, k, v
    read and o written (4BLD), or q, k, v, do read and dq, dk, dv written
    (7BLD)."""
    flops = (10 if backward else 4) * B * L * L * D * (0.5 if causal else 1.0)
    nbytes = (7 if backward else 4) * B * L * D * (torch.finfo(dtype).bits // 8)
    t_ops, t_bytes = flops / peaks[dtype], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def mlp_bound_ms(B, L, D, dtype, peaks):
    """(ms, "operations" | "bytes") for one B4 call.  FLOPs: 16BLD^2 (two
    products of 8BLD^2); bytes: x read, out and h_pre written (6BLD), W1 and
    W2 read (8D^2), the fp32 LN parameters and biases."""
    el = torch.finfo(dtype).bits // 8
    flops = 16 * B * L * D * D
    nbytes = 6 * B * L * D * el + 8 * D * D * el + 7 * D * 4
    t_ops, t_bytes = flops / peaks[dtype], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def mlp_inputs(B, L, D, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=g)).cuda()

    return (r(B, L, D).to(dtype), r(D, scale=0.1, shift=1.0), r(D, scale=0.1), r(D, 4 * D, scale=(2 * D) ** -0.5),
            r(4 * D, scale=0.1), r(4 * D, D, scale=D ** -0.5), r(D, scale=0.1))


def mlp_yardstick(x, ln_scale, ln_bias, w1t, b1, w2t, b2):
    """``F.layer_norm + F.linear + quick_gelu + F.linear`` and the residual,
    one library call per stage (weights pre-cast and transposed), timed only:
    no single PyTorch call computes the block."""
    F = torch.nn.functional
    y = F.layer_norm(x, (x.shape[-1],), ln_scale, ln_bias, 1e-5)
    h = F.linear(y, w1t, b1)
    return x + F.linear(h * torch.sigmoid(1.702 * h), w2t, b2)


def sdpa_ms(q, k, v, g, causal):
    """``F.scaled_dot_product_attention`` on [B, L, H, 64] views: (forward
    ms, autograd-backward ms), timed only (the port never calls it)."""
    F = torch.nn.functional
    q, k, v = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    gh = g.reshape(out.transpose(1, 2).shape).transpose(1, 2)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), gh, retain_graph=True))
    return fwd, bwd


def phase_impl_kernels(peaks) -> dict:
    """B4, B5 (forward, backward) and B6 (forward, backward) against their
    plain versions; per-shape cases of each."""
    from flyp_tpu_torch.testing import (
        attention_errors,
        backward_delta_from_o,
        backward_without_delta,
        check_attention,
        forward_cast_before_normalising,
    )

    out = {name: [] for name in ("B4", "B5_fwd", "B5_bwd", "B6_fwd", "B6_bwd")}
    for B, L, D, H, causal, dtypes in IMPL_SHAPES + LONG_SHAPES:
        for dtype in dtypes:
            where = (B, L, D, H, causal, str(dtype))
            common = dict(B=B, L=L, D=D, H=H, causal=causal, dtype=str(dtype).split(".")[-1])
            gen = torch.Generator().manual_seed(L + 2)
            g = torch.randn(B, L, D, generator=gen).cuda().to(dtype)
            qkv = torch.randn(B, L, 3 * D, generator=gen).cuda().to(dtype)
            q, k, v = (torch.randn(B, L, H, _HEAD_DIM, generator=gen).cuda().to(dtype) for _ in range(3))
            g4 = g.reshape(B, L, H, _HEAD_DIM)
            ops = {
                "B5": (lambda: fq.fused_qkv_attention(qkv, H, causal),
                       lambda: fq.fused_qkv_attention_reference(qkv, H, causal),
                       lambda: (fq.fused_qkv_attention_backward(qkv, g, H, causal),),
                       lambda: (fq.fused_qkv_attention_backward_reference(qkv, g, H, causal),),
                       fq._heads(qkv, H)),
                "B6": (lambda: fa.flash_attention(q, k, v, causal),
                       lambda: fa.flash_attention_reference(q, k, v, causal),
                       lambda: fa.flash_attention_backward(q, k, v, g4, causal),
                       lambda: fa.flash_attention_backward_reference(q, k, v, g4, causal),
                       (q, k, v)),
            }
            for name, (fwd, fwd_plain, bwd, bwd_plain, heads) in ops.items():
                with torch.no_grad():
                    got = fwd()
                    torch.cuda.synchronize()
                    f_errs = {"o": check_attention(f"{name} forward", got, fwd_plain(), where)}
                    got = bwd()
                    torch.cuda.synchronize()
                    ref = bwd_plain()
                    if name == "B5":  # one dqkv: its q, k and v thirds
                        got, ref = fq._heads(got[0], H), fq._heads(ref[0], H)
                    b_errs = {n: check_attention(f"{name} backward {n}", a, r, where)
                              for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
                    times = [cuda_ms(fn) for fn in (fwd, fwd_plain, bwd, bwd_plain)]
                lib_f, lib_b = sdpa_ms(*heads, g, causal)
                for direction, errs, ms, plain_ms, lib_ms, backward in (
                        ("fwd", f_errs, times[0], times[1], lib_f, False),
                        ("bwd", b_errs, times[2], times[3], lib_b, True)):
                    bound, by = attention_bound_ms(B, L, D, causal, dtype, peaks, backward)
                    out[f"{name}_{direction}"].append(dict(
                        common, max_abs_err=max(e["max_abs"] for e in errs.values()), errs=errs, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by))
                    log(f"{name}_{direction}", json.dumps(out[f"{name}_{direction}"][-1]))
            # The check's teeth: planted faults must fail it on the same
            # inputs.  The plain backward with delta dropped from ds, at every
            # shape; in bf16 also the forward that casts p before normalising
            # it and the backward whose delta is rowsum(do T(o)) (in fp32 the
            # casts round nothing, so those two are the op itself).
            with torch.no_grad():
                ref_o = fa.flash_attention_reference(q, k, v, causal)
                ref = fa.flash_attention_backward_reference(q, k, v, g4, causal)
                faults = {"delta dropped": (("dq", "dk"), backward_without_delta(q, k, v, g4, causal)[:2], ref[:2])}
                if dtype == torch.bfloat16:
                    faults["p cast before normalising"] = (("o",), (forward_cast_before_normalising(q, k, v, causal),),
                                                           (ref_o,))
                    faults["delta from rounded o"] = (("dq", "dk"), backward_delta_from_o(q, k, v, g4, causal)[:2],
                                                      ref[:2])
            for fault, (names, faulty, refs) in faults.items():
                caught = {}
                for n, a, r in zip(names, faulty, refs):
                    try:
                        check_attention("planted fault", a, r, where)
                    except AssertionError:
                        caught[n] = attention_errors(a, r)
                if len(caught) != len(names):
                    raise AssertionError(f"the attention check let a planted fault ({fault}) pass at {where}: "
                                         f"{caught}")
                out["B6_bwd"][-1].setdefault("planted_fault_errs", {})[fault] = caught
                log(f"planted fault ({fault}) caught", json.dumps({"where": list(map(str, where)), **caught}))
            if dtype == torch.bfloat16 and L > 256:
                out["B6_bwd"][-1]["long_row_checks"] = long_row_checks(ops, B, L, H, causal, where)
            del qkv, q, k, v, g, g4, ops, faults, ref, ref_o
    out["B4"] = mlp_cases(peaks)
    return out


def long_row_checks(ops, B, L, H, causal, where) -> dict:
    """B5 and B6 on the streamed route (bf16 above 256 keys): a second
    launch of each forward and backward equal bit for bit to the first; on
    inputs whose last key carries most of each row's weight
    (``testing.edge_key_qkv``), forward and backward within check_attention;
    and the planted fault of a row sum without the last 64-key tile
    (``testing.forward_without_last_tile``) failing it there."""
    from flyp_tpu_torch.testing import attention_errors, check_attention, edge_key_qkv, forward_without_last_tile

    dt, D = torch.bfloat16, H * _HEAD_DIM
    out = {}
    with torch.no_grad():
        for name, (fwd, _, bwd, _, _) in ops.items():
            first, second = (fwd(), *bwd()), (fwd(), *bwd())
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"{name} differs between two launches at {where}")
        out["repeat_bit_for_bit"] = list(ops)
        q, k, v, do = (torch.from_numpy(a).cuda().to(dt) for a in edge_key_qkv(B, L, H, seed=L + 3))
        qkv = torch.cat([t.reshape(B, L, D) for t in (q, k, v)], dim=-1)
        ref_o = fa.flash_attention_reference(q, k, v, causal)
        ref = fa.flash_attention_backward_reference(q, k, v, do, causal)
        got = {"B6": (fa.flash_attention(q, k, v, causal), *fa.flash_attention_backward(q, k, v, do, causal)),
               "B5": (fq.fused_qkv_attention(qkv, H, causal).reshape(B, L, H, _HEAD_DIM),
                      *fq._heads(fq.fused_qkv_attention_backward(qkv, do.reshape(B, L, D), H, causal), H))}
        torch.cuda.synchronize()
        for name, tensors in got.items():
            out[f"edge_key_{name}"] = {n: check_attention(f"{name} {n} (edge key)", a, r, where)["max_abs"]
                                       for n, a, r in zip(("o", "dq", "dk", "dv"), tensors, (ref_o, *ref))}
        faulty = forward_without_last_tile(q, k, v, causal)
        try:
            check_attention("planted fault", faulty, ref_o, where)
        except AssertionError:
            out["planted_fault_errs"] = {"l without the last tile": attention_errors(faulty, ref_o)}
        else:
            raise AssertionError(f"the attention check let a planted fault (l without the last tile) pass at {where}")
    log("long-row checks", json.dumps({"where": list(map(str, where)), **out}))
    return out


def edge_key_block_check(B, L, D, H, where) -> dict:
    """B3, B1 and B2 on the streamed route, on inputs whose last row's key
    carries most of each row's weight in every head
    (``testing.edge_key_block_inputs``), against their plain versions at
    TOL and BWD_TOL; a second launch of each equal bit for bit."""
    from flyp_tpu_torch.testing import edge_key_block_inputs

    dt = torch.bfloat16
    arrays, cot = edge_key_block_inputs(B, L, D, seed=L + 5, head_dim=D // H)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    args[0] = args[0].to(dt)
    x, ln_s, ln_b, wqkv, _, wout, _ = args
    g = torch.from_numpy(cot).cuda().to(dt)
    out = {}
    with torch.no_grad():
        runs = []
        for _ in range(2):
            b3 = ab.attention_block_inference(*args, H, False)
            b1 = ab._fwd_kernel_call(*args, H, False, train=True)
            b2 = ab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *b1[1:], H, False)
            runs.append({"B3": (b3,), "B1": b1, "B2": b2})
        torch.cuda.synchronize()
        for name in runs[0]:
            if not all(torch.equal(a, b) for a, b in zip(runs[0][name], runs[1][name])):
                raise AssertionError(f"{name} differs between two launches at {where} (edge key)")
        b3, b1, b2 = (runs[0][n] for n in ("B3", "B1", "B2"))
        out["B3"] = check_close("B3 (edge key)", b3[0], ab.attention_block_inference_reference(*args, H, False),
                                TOL[dt], where)
        ref = ab.attention_block_reference(*args, H, False)
        out["B1"] = max(check_close(f"B1 {n} (edge key)", a, r, TOL[dt], where)
                        for n, a, r in zip(("out", "o", "q", "k", "v"), b1, ref))
        _, o, q, k, v, lse = b1
        ref_b = ab.attention_block_backward_reference(g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, False)
        out["B2"] = check_close("B2 dx (edge key)", b2[0], ref_b[0], BWD_TOL[dt][0], where)
    log("edge-key block check", json.dumps({"where": list(map(str, where)), **out}))
    return out


# B4 at the vision and text widths of IMPL_SHAPES and at ViT-L/14's D = 1024
# (L = 257); its launches at the vision shape in bf16 are timed one by one.
MLP_SHAPES = [(B, L, D, dtypes) for B, L, D, _, _, dtypes in IMPL_SHAPES] + [(16, 257, 1024, BOTH)]
MLP_TIMED = (256, 197, 768)
MLP_LAUNCHES = {"ln": (r"ln_forward_kernel", None),
                "fc": (r"gemm_sm90_kernel<256, false, true, 2, ", lambda y, w1, h, w2, x: torch.mm(y, w1)),
                "gelu": (r"gelu_kernel", None),
                "proj": (r"gemm_sm90_kernel<256, false, true, 22, ", lambda y, w1, h, w2, x: torch.mm(h, w2))}


def mlp_launch_bound_ms(name, M, D, peaks):
    """(ms, "operations" | "bytes") for one of bf16 B4's launches: LN (x
    read, y written), fc (2MDHd; y, W1 read, h_pre written), the GELU (h_pre
    read, h written), proj (2MDHd; h, W2, x read, out written)."""
    Hd = 4 * D
    flops = 2 * M * D * Hd if name in ("fc", "proj") else 0
    nbytes = 2 * {"ln": 2 * M * D, "fc": M * D + D * Hd + M * Hd, "gelu": 2 * M * Hd,
                  "proj": M * Hd + Hd * D + 2 * M * D}[name]
    t_ops, t_bytes = flops / peaks[torch.bfloat16], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def mlp_cases(peaks) -> list:
    """B4 at MLP_SHAPES over NaN-poisoned outputs with a guard past each end:
    out and h_pre against the plain version (TOL); in bf16 also h, the
    transient between its products, held to the GELU of its own h_pre
    (``check_mlp_hidden``), which the planted fault (h of the unrounded sum)
    must fail; a second launch bit-equal; timed beside the plain version, a
    composite of one library call a stage and the card's bound."""
    from flyp_tpu_torch.testing import check_mlp_hidden, mlp_hidden_from_unrounded

    out = []
    for B, L, D, dtypes in MLP_SHAPES:
        for dtype in dtypes:
            where = ("B4", B, L, D, str(dtype))
            args = mlp_inputs(B, L, D, dtype, seed=L + 3)
            x, ln_s, ln_b, w1, b1, w2, b2 = args
            bf16 = dtype == torch.bfloat16
            bufs = {"out": poisoned((B, L, D), dtype), "h_pre": poisoned((B, L, 4 * D), dtype)}
            if bf16:
                bufs["hidden"] = poisoned((B, L, 4 * D), dtype)
            with torch.no_grad():
                got, h_pre = mb._kernel_forward(*args, **{n: b[0] for n, b in bufs.items()})
                torch.cuda.synchronize()
                for n, (_, guard) in bufs.items():
                    check_guard(f"B4 {n}", guard, where)
                ref, ref_h = mb.mlp_block_reference(*args)
                errs = {"h_pre": check_close("B4 h_pre", h_pre, ref_h, TOL[dtype], where),
                        "out": check_close("B4 out", got, ref, TOL[dtype], where)}
                case = dict(B=B, L=L, D=D, H=D // _HEAD_DIM, causal=False, dtype=str(dtype).split(".")[-1])
                if bf16:
                    case["hidden"] = check_mlp_hidden(bufs["hidden"][0], h_pre, where)
                    try:
                        check_mlp_hidden(mlp_hidden_from_unrounded(*args[:5]), h_pre, where)
                    except AssertionError as e:
                        log(f"planted fault (h of the unrounded sum) caught at {where}: {e}")
                    else:
                        raise AssertionError(f"check_mlp_hidden let h of the unrounded sum pass at {where}")
                again = mb._kernel_forward(*args, hidden=torch.empty_like(h_pre)) if bf16 else mb._kernel_forward(*args)
                if not (torch.equal(again[0], got) and torch.equal(again[1], h_pre)):
                    raise AssertionError(f"B4 differs between two launches at {where}")
                ms = cuda_ms(lambda: mb._kernel_forward(*args))
                plain_ms = cuda_ms(lambda: mb.mlp_block_reference(*args))
                yard = (x, ln_s.to(dtype), ln_b.to(dtype), w1.T.contiguous().to(dtype), b1.to(dtype),
                        w2.T.contiguous().to(dtype), b2.to(dtype))
                composite_ms = cuda_ms(lambda: mlp_yardstick(*yard))
                if bf16 and (B, L, D) == MLP_TIMED:
                    mm_ops = (mb._layer_norm(x.float(), ln_s, ln_b)[2].to(dtype).reshape(-1, D), w1.to(dtype),
                              mb.mlp_hidden(h_pre).reshape(-1, 4 * D), w2.to(dtype), x)
                    case["launches_ms"] = {
                        n: dict(ms=kernel_ms(lambda: mb._kernel_forward(*args), pattern),
                                bound_ms=mlp_launch_bound_ms(n, B * L, D, peaks)[0],
                                mm_ms=cuda_ms(lambda: mm(*mm_ops)) if mm else None)
                        for n, (pattern, mm) in MLP_LAUNCHES.items()}
                    del mm_ops
            bound, by = mlp_bound_ms(B, L, D, dtype, peaks)
            out.append(dict(case, max_abs_err=max(errs.values()), errs=errs, ms=ms, plain_ms=plain_ms,
                            composite_ms=composite_ms, bound_ms=bound, bound_by=by))
            log("B4", json.dumps(out[-1]))
            del args, yard, bufs, got, h_pre, again, ref, ref_h
    torch.cuda.empty_cache()
    return out


IMPLS = ("pallas_block", "pallas_qkv", "pallas", "pallas_block_mlp", "xla")
# The kernels each route launches once per block: in a train step, and in
# an eval forward.  Every other kernel must not launch under the route.
ROUTE_TRAIN = {"pallas_block": ("B1", "B2"), "pallas_qkv": ("B5_fwd", "B5_bwd"), "pallas": ("B6_fwd", "B6_bwd"),
               "pallas_block_mlp": ("B1", "B2", "B4"), "xla": ()}
ROUTE_SERVE = {"pallas_block": ("B3",), "pallas_qkv": ("B5_fwd",), "pallas": ("B6_fwd",),
               "pallas_block_mlp": ("B3", "B4"), "xla": ()}


def layer_ms(model, train: bool) -> dict:
    """Device ms (CUDA events) of one vision block's attention and MLP
    sub-blocks at the training main path's shape (B=256, L=197, bf16):
    forward and backward (input and parameter grads) in training mode, the
    forward in eval mode."""
    blk = model.visual.transformer.block_0
    blk.train(train)
    W = model.config.vision.width
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(256, 197, W, generator=gen).cuda().to(torch.bfloat16)
    g = torch.randn(256, 197, W, generator=gen).cuda().to(torch.bfloat16)
    params = list(blk.parameters())
    out = {}
    for name, fn in (("attention", blk.attention), ("mlp", blk.feed_forward)):
        if train:
            xi = x.detach().requires_grad_(True)
            out[name] = cuda_ms(lambda: torch.autograd.grad(fn(xi), [xi] + params, g, allow_unused=True), iters=10)
        else:
            with torch.inference_mode():
                out[name] = cuda_ms(lambda: fn(x), iters=10)
    return out


def phase_impls(card: str) -> dict:
    """The routes other than the default pallas_block (which phase_serving
    and phase_training measure) at full ViT-B/16 width: the step against the
    CPU (all but xla), 13 train steps and one 256-image request with exact
    launch counts, img/s, and the sub-blocks' device ms."""
    cfg = {n: SimpleNamespace(model=MODEL, clip_load=None, compute_dtype=n, seed=0) for n in ("float32", "bfloat16")}
    px, layers_v, _ = model_shape()
    results = {}
    for impl in IMPLS[1:]:
        use_impl(impl)
        res = {}
        if impl != "xla":
            images, tokens = bench_batch(4, px, seed=1)
            res.update(step_check(cfg, images, tokens, impl))
        model = build_clip_model(cfg["bfloat16"], device="cuda")
        state, step, images, tokens, bench = bench_training(model, impl, card)
        res.update(bench, layers_train_ms=layer_ms(model, train=True))
        model.train()
        res["profile"] = device_profile(lambda: step(state, images, tokens), {"port_kernels": PORT_KERNELS})

        model.eval()
        srv = ClipServer.for_classification(model, CLASSNAMES, simple_template, image_buckets=(BUCKETS[-1],))
        batch = np.random.default_rng(3).standard_normal((BUCKETS[-1], px, px, 3)).astype(np.float32)
        srv.classify(batch)
        reset_counts()
        # ---- the serving path under this route: counts start at 0 here ---
        logits = srv.classify(batch)
        serve_launches = counts()
        # ---- end of the serving path --------------------------------------
        expect_counts(f"classify under {impl}", **{k: layers_v for k in ROUTE_SERVE[impl]})
        if logits.shape != (len(batch), len(CLASSNAMES)) or not np.isfinite(logits).all():
            raise AssertionError(f"classify under {impl}: logits {logits.shape}")
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            srv.classify(batch)
        res.update(serve_img_s=reps * len(batch) / (time.perf_counter() - t0), serve_launches=serve_launches,
                   layers_eval_ms=layer_ms(model, train=False))
        log(f"route {impl}: classify at bucket {BUCKETS[-1]} {res['serve_img_s']:.1f} img/s, vision block ms train "
            f"{res['layers_train_ms']}, eval {res['layers_eval_ms']} on {card}")
        results[impl] = res
        del model, state, step, srv, images, tokens
        torch.cuda.empty_cache()
    use_impl("auto")
    return results


# Phase 8: the measurement probes' kernels (T1-T4) against their plain
# versions, and the two ported tools end to end.  T1 at the serving (qkv,
# out) and ceiling (big) shapes at batch 256, at tests/test_tools.py's shapes
# and at one with a ragged last row tile; each shape the op cannot tile must
# raise ValueError naming the dimension.
PROBE_GEMM_SHAPES = [("qkv", 53248, 768, 2304), ("out", 53248, 768, 768), ("big", 16384, 4096, 4096),
                     ("tools", 1024, 768, 512), ("tools", 512, 768, 2304), ("tools", 512, 768, 768),
                     ("ragged M", 1000, 768, 640), ("ragged M", 200, 768, 512), ("ragged M", 8, 768, 128)]
PROBE_REFUSED = [((512, 768, 200), torch.int8, "N=200"), ((512, 96, 512), torch.int8, "K=96"),
                 ((512, 100, 512), torch.bfloat16, "K=100")]
# T2's q, k [B, L, D]: ViT-B/16 at batch 256, at the TPU tool's padded
# length and at its exact one (odd: the column mask, scalar stores), and
# ViT-L/14's odd lengths at batch 64, wider than one 256-column tile.
PROBE_SCORE = [(256, 208, 768), (256, 197, 768), (64, 257, 1024), (64, 577, 1024)]
PROBE_ROWS = (256, 768, 2304)  # T3's B, D, N: the QKV projection at batch 256
ADAMW_CHECK_PARAMS = 16 * 1024 * 1024
ADAMW_PARAMS = 150_000_000 // 1024 // 2048 * 2048 * 1024  # the TPU probe's 148,897,792
TOOL_BATCH = 256
ZEROSHOT_CLASSES = 100  # the probe's default of 1000 stays on its CLI
PROBE_GUARD = 1 << 16  # elements past a probe's output that must stay NaN


def probe_gemm_bound_ms(M, K, N, kind, peaks):
    """(ms, "operations" | "bytes") for one T1 call: 2MKN operations; a and
    b read once, the 4-byte output written once."""
    el, peak = (2, peaks[torch.bfloat16]) if kind == "bf16" else (1, peaks[torch.int8])
    t_ops, t_bytes = 2 * M * K * N / peak, ((M * K + K * N) * el + 4 * M * N) / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def score_depth_bound_ms(B, L, D, peaks):
    """T2: 2BL^2D bf16 operations; q and k read once, fp32 o written once."""
    t_ops, t_bytes = 2 * B * L * L * D / peaks[torch.bfloat16], (4 * B * L * D + 4 * B * L * L) / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def row_gemm_bound_ms(B, R, D, N, peaks):
    """T3: 2BRDN bf16 operations; x and w read once, bf16 out written once."""
    t_ops, t_bytes = 2 * B * R * D * N / peaks[torch.bfloat16], 2 * (B * R * D + D * N + B * R * N) / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def adamw_bound_ms(n, mdtype, peaks):
    """T4: p, m, v, g read and p, m, v written once (26 bytes a parameter
    with fp32 moments, 18 with bf16); 16 fp32 operations a parameter."""
    msz = torch.finfo(mdtype).bits // 8
    t_ops, t_bytes = 16 * n / peaks[torch.float32], n * (4 + 2 + 2 * msz + 4 + 2 * msz) / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def probe_gemm_cases(peaks) -> dict:
    """T1 in both types at every shape: the output poisoned with a sentinel
    before the launch (an uncomputed element fails the check) and a guard
    past its end that must stay untouched; int8 exactly equal to the plain
    version; bf16 held to the exact product within the block-FMA bound of
    fp32 tensor-core accumulation (``check_gemm``), its max abs error against
    the fp32 plain version reported; a second launch bit-equal."""
    out = {"bf16": [], "int8": []}
    gen = torch.Generator(device="cuda").manual_seed(8)
    for label, M, K, N in PROBE_GEMM_SHAPES:
        where = (label, M, K, N)
        for kind, out_dtype in (("bf16", torch.float32), ("int8", torch.int32)):
            if kind == "bf16":
                a = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
                b = torch.randn(K, N, generator=gen, device="cuda").to(torch.bfloat16)
            else:
                a = torch.randint(-127, 127, (M, K), generator=gen, device="cuda", dtype=torch.int8)
                b = torch.randint(-127, 127, (K, N), generator=gen, device="cuda", dtype=torch.int8)
            c, guard = poisoned((M, N), out_dtype)
            got = tip.probe_mm(a, b, out_dtype, out=c)
            torch.cuda.synchronize()
            check_guard(f"T1 {kind}", guard, where)
            if not torch.equal(got, tip.probe_mm(a, b, out_dtype)):
                raise AssertionError(f"T1 {kind} differs between two launches at {where}")
            ref = tip.probe_mm_reference(a, b, out_dtype)
            if kind == "int8":
                if not torch.equal(got, ref):
                    raise AssertionError(f"T1 int8 differs from the exact product at {where}: "
                                         f"{int((got != ref).sum())} elements")
                err = 0.0
            else:
                vs_exact = check_gemm("T1 bf16", got, a, b, where)
                err = (got - ref).abs().max().item()
            ms = cuda_ms(lambda: tip.probe_mm(a, b, out_dtype))
            plain_ms = cuda_ms(lambda: tip.probe_mm_reference(a, b, out_dtype))
            # torch._int_mm takes M > 16 only: no library call below that.
            library_ms = cuda_ms(lambda: tip.library_mm(a, b, out_dtype)) if kind == "bf16" or M > 16 else None
            bound, by = probe_gemm_bound_ms(M, K, N, kind, peaks)
            extra = {} if kind == "int8" else {"vs_exact": vs_exact}
            out[kind].append(dict(shape=f"{label} [{M},{K}]x[{K},{N}] {kind}", M=M, K=K, N=N, max_abs_err=err,
                                  **extra, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                                  bound_by=by, tops=2 * M * K * N / ms / 1e9))
            log(f"T1_{kind}", json.dumps(out[kind][-1]))
            del a, b, c, guard, got, ref
    for (M, K, N), dtype, dim in PROBE_REFUSED:
        out_dtype = torch.int32 if dtype == torch.int8 else torch.float32
        a, b = torch.zeros(M, K, dtype=dtype, device="cuda"), torch.zeros(K, N, dtype=dtype, device="cuda")
        try:
            tip.probe_mm(a, b, out_dtype)
        except ValueError as e:
            if dim not in str(e):
                raise AssertionError(f"T1 refused [{M},{K}]x[{K},{N}] without naming {dim}: {e}") from e
            log(f"T1 refuses {dtype} [{M},{K}]x[{K},{N}]: {e}")
            continue
        raise AssertionError(f"T1 accepted [{M},{K}]x[{K},{N}] {dtype}, which its tiles cannot cover")
    return out


def poisoned(shape, dtype):
    """An output filled with a sentinel (NaN; int32's least value) and a
    guard region of PROBE_GUARD elements just past its end, in one buffer."""
    n = math.prod(shape)
    fill = torch.iinfo(dtype).min if dtype == torch.int32 else float("nan")
    buf = torch.full((n + PROBE_GUARD,), fill, dtype=dtype, device="cuda")
    return buf[:n].view(shape), buf[n:]


def check_guard(name, guard, where):
    intact = guard == torch.iinfo(guard.dtype).min if guard.dtype == torch.int32 else torch.isnan(guard)
    if not bool(intact.all()):
        raise AssertionError(f"{name} wrote past the end of its output at {where}: "
                             f"{int((~intact).sum())} guard elements")


def score_depth_cases(peaks) -> list:
    """T2 at each PROBE_SCORE shape and hd: over a poisoned output with a
    guard (1e-4 + 1e-5 |ref| of the plain version, which holds every
    element, so one left unwritten fails), a second launch bit-equal, timed
    beside the plain version, ``torch.bmm`` and the card's bound."""
    out = []
    gen = torch.Generator(device="cuda").manual_seed(9)
    bmm_fp32 = tip.has_out_dtype("bmm")
    for B, L, D in PROBE_SCORE:
        q = torch.randn(B, L, D, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(B, L, D, generator=gen, device="cuda").to(torch.bfloat16)
        for hd in tml.SCORE_DEPTHS:
            where = ("T2", B, L, D, hd)
            o, guard = poisoned((B, L, L), torch.float32)
            got = tml.score_depth(q, k, hd, out=o)
            torch.cuda.synchronize()
            err = check_close("T2", got, tml.score_depth_reference(q, k, hd), 1e-4, where, rtol=1e-5)
            check_guard("T2", guard, where)
            if not torch.equal(got, tml.score_depth(q, k, hd)):
                raise AssertionError(f"T2 differs between two launches at {where}")
            library = ((lambda: torch.bmm(q, k.mT, out_dtype=torch.float32)) if bmm_fp32
                       else (lambda: torch.bmm(q, k.mT)))
            bound, by = score_depth_bound_ms(B, L, D, peaks)
            out.append(dict(shape=f"hd={hd} q,k [{B},{L},{D}] bf16", hd=hd, L=L, max_abs_err=err,
                            ms=cuda_ms(lambda: tml.score_depth(q, k, hd)),
                            plain_ms=cuda_ms(lambda: tml.score_depth_reference(q, k, hd)),
                            library_ms=cuda_ms(library), library_out="float32" if bmm_fp32 else "bfloat16",
                            bound_ms=bound, bound_by=by))
            log("T2", json.dumps(out[-1]))
            del o, guard, got
        del q, k
    torch.cuda.empty_cache()
    return out


def row_gemm_cases(peaks) -> list:
    """T3 at each of the tool's row counts: over a poisoned output with a
    guard, within one bf16 ulp of the plain version plus 1e-4, mean error
    under 1e-3, a second launch bit-equal, timed beside the plain version,
    ``torch.matmul`` and the card's bound."""
    out = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    B, D, N = PROBE_ROWS
    w = torch.randn(D, N, generator=gen, device="cuda").to(torch.bfloat16)
    for R in tml.ROW_COUNTS:
        where = ("T3", B, R, D, N)
        x = torch.randn(B, R, D, generator=gen, device="cuda").to(torch.bfloat16)
        o, guard = poisoned((B, R, N), torch.bfloat16)
        got = tml.row_gemm(x, w, out=o)
        torch.cuda.synchronize()
        ref = tml.row_gemm_reference(x, w).float()
        # One bf16 ulp of the value (2^-7 |ref|), plus 1e-4 for outputs near
        # zero, where the fp32 sums' order (T1's 1e-4 at K=768) is not small
        # beside the value; mean abs error under 1e-3.
        err = check_close("T3", got.float(), ref, 1e-4, where, rtol=2.0 ** -7)
        mean_err = (got.float() - ref).abs().mean().item()
        if mean_err >= 1e-3:
            raise AssertionError(f"T3 at R={R}: mean abs err {mean_err}")
        check_guard("T3", guard, where)
        if not torch.equal(got, tml.row_gemm(x, w)):
            raise AssertionError(f"T3 differs between two launches at {where}")
        bound, by = row_gemm_bound_ms(B, R, D, N, peaks)
        out.append(dict(shape=f"R={R} x [{B},{R},{D}] w [{D},{N}] bf16", R=R, max_abs_err=err,
                        mean_abs_err=mean_err, ms=cuda_ms(lambda: tml.row_gemm(x, w)),
                        plain_ms=cuda_ms(lambda: tml.row_gemm_reference(x, w)),
                        library_ms=cuda_ms(lambda: torch.matmul(x, w)), bound_ms=bound, bound_by=by))
        log("T3", json.dumps(out[-1]))
        del x, o, guard, got, ref
    del w
    torch.cuda.empty_cache()
    return out


def phase_probes(peaks) -> dict:
    """T1-T4 against their plain versions, then the ported tools' paths with
    every kernel's launches counted."""
    t1 = probe_gemm_cases(peaks)
    return {"T1_bf16": t1["bf16"], "T1_int8": t1["int8"], "T2": score_depth_cases(peaks),
            "T3": row_gemm_cases(peaks), "T4": adamw_cases(peaks)}


def adamw_cases(peaks) -> list:
    """T4 against its plain version (the same uncontracted fp32 formula on
    both sides: p within 1e-6 of its terms' magnitudes, the moments equal) on
    ADAMW_CHECK_PARAMS parameters and on the probe's 148,897,792, then timed
    at the latter beside the plain version and ``torch._fused_adamw_`` (fp32
    moments only; another rounding order, and fp32 grads)."""
    out = []
    gen = torch.Generator(device="cuda").manual_seed(10)
    for mdtype in BOTH:
        name = str(mdtype).split(".")[-1]
        max_err = 0.0
        for n in (ADAMW_CHECK_PARAMS, ADAMW_PARAMS):
            p = torch.randn(n, generator=gen, device="cuda")
            m = (0.01 * torch.randn(n, generator=gen, device="cuda")).to(mdtype)
            v = (1e-4 * torch.randn(n, generator=gen, device="cuda") ** 2).to(mdtype)
            g = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
            ref = tml.adamw_update_reference(p, m, v, g, tml.ADAMW_COUNT)
            got = tml.adamw_update(p.clone(), m.clone(), v.clone(), g, tml.ADAMW_COUNT)
            torch.cuda.synchronize()
            # p' = p - lr (...): 1e-6 of the two terms' magnitudes, as they
            # may cancel.
            max_err = max(max_err, check_close("T4 p", got[0], ref[0], 1e-6 * (p.abs() + (p - ref[0]).abs()),
                                               ("T4", n, name), rtol=0.0))
            for label, a, r in zip(("m", "v"), got[1:], ref[1:]):
                if not torch.equal(a, r):
                    raise AssertionError(f"T4 {label} ({name} moments) differs from the plain version at "
                                         f"{int((a != r).sum())} of {n}")
            del ref, got
            if n != ADAMW_PARAMS:
                del p, m, v, g
                continue
            ms = cuda_ms(lambda: tml.adamw_update(p, m, v, g, tml.ADAMW_COUNT))
            plain_ms = cuda_ms(lambda: tml.adamw_update_reference(p, m, v, g, tml.ADAMW_COUNT))
            library_ms = None
            if mdtype == torch.float32:
                g32, step = g.float(), torch.tensor(float(tml.ADAMW_COUNT), device="cuda")
                library_ms = cuda_ms(lambda: torch._fused_adamw_(
                    [p], [g32], [m], [v], [], [step], lr=tml.LR, beta1=tml.B1, beta2=tml.B2, weight_decay=tml.WD,
                    eps=tml.EPS, amsgrad=False, maximize=False))
                del g32
            bound, by = adamw_bound_ms(n, mdtype, peaks)
            out.append(dict(shape=f"{n} params, {name} moments", moments=name, n=n, max_abs_err=max_err, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            library_note="torch._fused_adamw_: not the same rounding" if library_ms else None,
                            bound_ms=bound, bound_by=by, gb_s=n * (4 + 2 + 4 * (torch.finfo(mdtype).bits // 8) + 4)
                            / ms / 1e6))
            log("T4", json.dumps(out[-1]))
            del p, m, v, g
            torch.cuda.empty_cache()
    return out


def run_tool(where: str, fn, **expected) -> dict:
    """Run a ported tool's path with every count at 0 just before it; its
    printed lines and every kernel's launches, exactly ``expected``."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    reset_counts()
    # ---- the tool's path: counts start at 0 here ----------------------------
    with contextlib.redirect_stdout(buf):
        fn()
    launches = counts()
    # ---- end of the tool's path ---------------------------------------------
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"  {where}: {line}")
    expect_counts(where, **expected)
    return {"lines": buf.getvalue().splitlines(), "launches": {k: n for k, n in launches.items() if n},
            "seconds": seconds}


def phase_tools() -> dict:
    """The two ported tools on the card: ``int8_matmul_probe`` (``main`` and
    ``main_pallas`` at batch 256) and every ``mfu_levers`` probe, the head
    rebuild at ZEROSHOT_CLASSES classes x 80 templates."""
    out = {}
    n_shapes = 3  # main_pallas: qkv, out, big
    out[f"int8_matmul_probe pallas {TOOL_BATCH}"] = run_tool(
        f"int8_matmul_probe pallas {TOOL_BATCH}", lambda: tip.main_pallas(TOOL_BATCH),
        T1_bf16=n_shapes * (tip.ITERS + 1), T1_int8=n_shapes * (tip.ITERS + 2))
    out[f"int8_matmul_probe {TOOL_BATCH}"] = run_tool(f"int8_matmul_probe {TOOL_BATCH}",
                                                      lambda: tip.main(TOOL_BATCH))
    prompts = ZEROSHOT_CLASSES * 80
    chunks = -(-prompts // 2048)
    for name, probe in tml.PROBES.items():
        expected = {"depth": {"T2": len(tml.SCORE_DEPTHS) * (tml.ITERS + 1)},
                    "row_quant": {"T3": len(tml.ROW_COUNTS) * (tml.ITERS + 1)},
                    "adamw_pallas": {"T4": 2 * (tml.ADAMW_ITERS + 1)},
                    "zeroshot": {"B3": 2 * chunks * MODEL_CONFIGS[MODEL].text.layers}}.get(name, {})
        heads = []
        fn = (lambda: heads.append(probe(num_classes=ZEROSHOT_CLASSES))) if name == "zeroshot" else probe
        out[f"mfu_levers {name}"] = run_tool(f"mfu_levers {name}", fn, **expected)
        if heads:
            out[f"mfu_levers {name}"]["head_cosine_to_plain"] = zeroshot_head_cosine(heads[-1])
        torch.cuda.empty_cache()
    return out


def zeroshot_head_cosine(head, classnames=None, model=None) -> float:
    """A zero-shot head (B3 in every text block) against the head of the
    same seed-0 model on a plain path, over ``openai_imagenet_template``:
    the least cosine of a class's row, at least 0.99 in bf16 (the serving
    phase's bound).  By default the probe's head (``ZEROSHOT_CLASSES``
    classes) against the model on the card under the plain ``xla`` route;
    with ``model`` (e.g. on the CPU, where every op takes its plain version)
    the first ``len(classnames)`` rows of ``head`` against a head of those
    classes built on it."""
    from flyp_tpu_torch.templates import get_template

    template = get_template("openai_imagenet_template")
    if model is None:
        cfg = SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="bfloat16", seed=0)
        model = build_clip_model(cfg, device="cuda")
        classnames = [f"class number {i}" for i in range(ZEROSHOT_CLASSES)]
        use_impl("xla")
        try:
            plain = get_zeroshot_classifier(model, classnames, template, encode_batch=2048)
        finally:
            use_impl("auto")
    else:
        plain = get_zeroshot_classifier(model, classnames, template)
    got, ref = head.weight[:len(classnames)].float().cpu(), plain.weight.float().cpu()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"zero-shot head {tuple(got.shape)} against the plain {tuple(ref.shape)}, or not finite")
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"zero-shot head against the plain path ({len(classnames)} classes on {model.device}): least class cosine "
        f"{cos:.6f}")
    if cos < 0.99:
        raise AssertionError(f"zero-shot head drifts from the plain path: least class cosine {cos}")
    return cos


def digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests() -> dict:
    """A SHA-256 prefix of each attention kernel's outputs (B3, B1, B2, and
    B5 and B6 forward and backward), of B4's (out, h_pre) and of T1's (bf16
    and int8) on seeded inputs at the main paths' shapes.  ``python3
    chip_smoke.py --digests`` run twice from one tree says whether the
    kernels repeat bit for bit; run from two trees (this script copied into
    the other), whether a change kept their bits."""
    out = {}
    for B, L, D, H, causal in ((256, 197, 768, 12, False), (256, 32, 512, 8, True), (64, 197, 768, 12, False)):
        for dtype in BOTH:
            args = block_inputs(B, L, D, dtype, seed=L + 1)
            x, ln_s, ln_b, wqkv, _, wout, _ = args
            g = torch.randn(B, L, D, generator=torch.Generator().manual_seed(L)).cuda().to(dtype)
            qkv = torch.randn(B, L, 3 * D, generator=torch.Generator().manual_seed(L + 2)).cuda().to(dtype)
            heads = fq._heads(qkv, H)
            g4 = g.reshape(B, L, H, _HEAD_DIM)
            with torch.no_grad():
                b3 = ab.attention_block_inference(*args, H, causal)
                b1 = ab._fwd_kernel_call(*args, H, causal, train=True)
                b2 = ab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *b1[1:], H, causal)
                b5 = (fq.fused_qkv_attention(qkv, H, causal), fq.fused_qkv_attention_backward(qkv, g, H, causal))
                b6 = (fa.flash_attention(*heads, causal), *fa.flash_attention_backward(*heads, g4, causal))
                b4 = mb._kernel_forward(*mlp_inputs(B, L, D, dtype, seed=L + 3))
            for name, tensors in (("B3", (b3,)), ("B1", b1), ("B2", b2), ("B5", b5), ("B6", b6), ("B4", b4)):
                out[f"{name} B={B} L={L} {str(dtype).split('.')[-1]}"] = digest(tensors)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for M, K, N in ((1024, 768, 512), (1000, 768, 640)):
        a = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn(K, N, generator=gen, device="cuda").to(torch.bfloat16)
        a8 = torch.randint(-127, 127, (M, K), generator=gen, device="cuda", dtype=torch.int8)
        b8 = torch.randint(-127, 127, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        out[f"T1 bf16 [{M},{K}]x[{K},{N}]"] = digest((tip.probe_mm(a, b, torch.float32),))
        out[f"T1 int8 [{M},{K}]x[{K},{N}]"] = digest((tip.probe_mm(a8, b8, torch.int32),))
    return out


# ViT-L/14's vision rows, on the streamed route (bf16 above 256 keys): at
# 224 px (L = 257, the recipe's batch 256) and at 336 px (L = 577, the
# serving bench's batch 64); D = 1024, H = 16.
LONG_ROW_SHAPES = [(256, 257, 1024, 16), (64, 577, 1024, 16)]
# (B, L, D, H, causal): the vision and text shapes of ViT-B/16's main path,
# then ViT-L/14's long rows.
ATTENTION_TIME_SHAPES = [(256, 197, 768, 12, False), (256, 32, 512, 8, True),
                         *((B, L, D, H, False) for B, L, D, H in LONG_ROW_SHAPES)]


def attention_times() -> dict:
    """Device ms of the attention kernels alone, bf16, at
    ATTENTION_TIME_SHAPES: B5 and B6 per op call, beside
    ``F.scaled_dot_product_attention``'s forward and autograd backward on
    the same q, k, v (``sdpa_fwd``, ``sdpa_bwd``: their library_ms), and the
    attention step inside B3, B1 and B2 (the device time of their attention
    kernels under torch.profiler).  ``python3 chip_smoke.py
    --attention-times`` prints only these and ``long_row_cases``, for
    comparing kernel designs in one call."""
    out = {}
    for B, L, D, H, causal in ATTENTION_TIME_SHAPES:
        dt = torch.bfloat16
        gen = torch.Generator().manual_seed(L)
        q, k, v, do = (torch.randn(B, L, H, _HEAD_DIM, generator=gen).cuda().to(dt) for _ in range(4))
        qkv = torch.randn(B, L, 3 * D, generator=gen).cuda().to(dt)
        g = do.reshape(B, L, D)
        args = block_inputs(B, L, D, dt, seed=L + 1)
        x, ln_s, ln_b, wqkv, _, wout, _ = args
        with torch.no_grad():
            _, bo, bq, bk, bv, lse = ab._fwd_kernel_call(*args, H, causal, train=True)
            res = {"B6_fwd": cuda_ms(lambda: fa.flash_attention(q, k, v, causal)),
                   "B6_bwd": cuda_ms(lambda: fa.flash_attention_backward(q, k, v, do, causal)),
                   "B5_fwd": cuda_ms(lambda: fq.fused_qkv_attention(qkv, H, causal)),
                   "B5_bwd": cuda_ms(lambda: fq.fused_qkv_attention_backward(qkv, g, H, causal)),
                   "B3_attention": kernel_ms(lambda: ab.attention_block_inference(*args, H, causal), B3_ATTENTION),
                   "B1_attention": kernel_ms(lambda: ab._fwd_kernel_call(*args, H, causal, train=True),
                                             B1_ATTENTION),
                   "B2_attention": kernel_ms(lambda: ab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, bo, bq, bk,
                                                                         bv, lse, H, causal), B2_ATTENTION)}
        res["sdpa_fwd"], res["sdpa_bwd"] = sdpa_ms(q, k, v, g, causal)
        out[f"B={B} L={L} D={D} H={H}{' causal' if causal else ''} bfloat16"] = res
        log("attention times", json.dumps({f"B={B} L={L}": res}))
        del q, k, v, do, qkv, g, args, x, ln_s, ln_b, wqkv, wout, bo, bq, bk, bv, lse
        torch.cuda.empty_cache()
    return out


def long_row_cases(peaks) -> dict:
    """B3, B1, B2 and B5/B6 (forward and backward) in bf16 at
    LONG_ROW_SHAPES, the streamed route's main-path shapes: each call
    checked against its plain version (B1-B3 at TOL and BWD_TOL, B5/B6 to
    check_attention), then timed beside its plain version, the bound and
    one library call (SDPA for B5/B6) or, for B1-B3, the composite
    yardstick and their attention step alone under the profiler beside
    SDPA's.  The plain versions run 3 times after a warm-up (they hold
    [B, H, L, L] fp32 scores)."""
    from flyp_tpu_torch.testing import check_attention

    out = {name: [] for name in ("B3", "B1", "B2", "B5_fwd", "B5_bwd", "B6_fwd", "B6_bwd")}
    dt = torch.bfloat16

    def plain_ms(fn):
        return cuda_ms(fn, iters=3, warmup=1)

    for B, L, D, H in LONG_ROW_SHAPES:
        t0 = time.perf_counter()
        common = dict(B=B, L=L, D=D, H=H, causal=False, dtype="bfloat16")
        where = (B, L, D, H, False, "bfloat16")
        args = block_inputs(B, L, D, dt, seed=L + 7)
        x, ln_s, ln_b, wqkv, _, wout, _ = args
        g = torch.randn(B, L, D, generator=torch.Generator().manual_seed(L + 8)).cuda().to(dt)
        sdpa_f, sdpa_b = attention_yardstick_ms(B, L, D, H, False, dt)
        with torch.no_grad():
            err3 = check_close("B3", ab.attention_block_inference(*args, H, False),
                               ab.attention_block_inference_reference(*args, H, False), TOL[dt], where)
            got = ab._fwd_kernel_call(*args, H, False, train=True)
            ref = ab.attention_block_reference(*args, H, False)
            err1 = max(check_close(f"B1 {n}", a, r, TOL[dt], where) for n, a, r in zip(("out", "o"), got, ref))
            _, o, q, k, v, lse = got
            bwd_args = (g, x, ln_s, ln_b, wqkv, wout, o, q, k, v, lse, H, False)
            ref_b = ab.attention_block_backward_reference(*bwd_args)
            err2 = check_close("B2 dx", ab._bwd_kernel_call(*bwd_args)[0], ref_b[0], BWD_TOL[dt][0], where)
            del ref, ref_b
            torch.cuda.empty_cache()
            rows = {
                "B3": (err3, lambda: ab.attention_block_inference(*args, H, False),
                       lambda: ab.attention_block_inference_reference(*args, H, False), B3_ATTENTION, sdpa_f,
                       block_bound_ms(B, L, D, False, dt, peaks)),
                "B1": (err1, lambda: ab._fwd_kernel_call(*args, H, False, train=True),
                       lambda: ab.attention_block_reference(*args, H, False), B1_ATTENTION, sdpa_f,
                       block_bound_ms(B, L, D, False, dt, peaks)),
                "B2": (err2, lambda: ab._bwd_kernel_call(*bwd_args),
                       lambda: ab.attention_block_backward_reference(*bwd_args), B2_ATTENTION, sdpa_b,
                       bwd_bound_ms(B, L, D, H, False, dt, peaks)),
            }
            for name, (err, fn, plain, pattern, sdpa, (bound, by)) in rows.items():
                out[name].append(dict(common, max_abs_err=err, ms=cuda_ms(fn), plain_ms=plain_ms(plain),
                                      bound_ms=bound, bound_by=by, attention_ms=kernel_ms(fn, pattern), sdpa_ms=sdpa))
                torch.cuda.empty_cache()
        yin = [t.detach().clone().requires_grad_(True) for t in args]
        out["B3"][-1]["composite_ms"] = out["B1"][-1]["composite_ms"] = cuda_ms(lambda: yardstick(*yin, H, False))
        yout = yardstick(*yin, H, False)
        out["B2"][-1]["composite_ms"] = cuda_ms(lambda: torch.autograd.grad(yout, yin, g, retain_graph=True))
        del yin, yout, args, x, wqkv, wout, got, o, q, k, v, lse, bwd_args, rows
        torch.cuda.empty_cache()

        gen = torch.Generator().manual_seed(L + 9)
        qkv = torch.randn(B, L, 3 * D, generator=gen).cuda().to(dt)
        heads = [torch.randn(B, L, H, _HEAD_DIM, generator=gen).cuda().to(dt) for _ in range(3)]
        g4 = g.reshape(B, L, H, _HEAD_DIM)
        ops = {
            "B5": (lambda: fq.fused_qkv_attention(qkv, H, False),
                   lambda: fq.fused_qkv_attention_reference(qkv, H, False),
                   lambda: fq._heads(fq.fused_qkv_attention_backward(qkv, g, H, False), H),
                   lambda: fq._heads(fq.fused_qkv_attention_backward_reference(qkv, g, H, False), H),
                   fq._heads(qkv, H)),
            "B6": (lambda: fa.flash_attention(*heads, False), lambda: fa.flash_attention_reference(*heads, False),
                   lambda: fa.flash_attention_backward(*heads, g4, False),
                   lambda: fa.flash_attention_backward_reference(*heads, g4, False), heads),
        }
        for name, (fwd, fwd_plain, bwd, bwd_plain, qkv_heads) in ops.items():
            with torch.no_grad():
                f_err = check_attention(f"{name} forward", fwd(), fwd_plain(), where)["max_abs"]
                b_err = max(check_attention(f"{name} backward {n}", a, r, where)["max_abs"]
                            for n, a, r in zip(("dq", "dk", "dv"), bwd(), bwd_plain()))
                torch.cuda.empty_cache()
                times = (cuda_ms(fwd), plain_ms(fwd_plain), cuda_ms(bwd), plain_ms(bwd_plain))
            lib_f, lib_b = sdpa_ms(*qkv_heads, g, False)
            for direction, err, ms, p_ms, lib, backward in (("fwd", f_err, times[0], times[1], lib_f, False),
                                                            ("bwd", b_err, times[2], times[3], lib_b, True)):
                bound, by = attention_bound_ms(B, L, D, False, dt, peaks, backward)
                out[f"{name}_{direction}"].append(dict(common, max_abs_err=err, ms=ms, plain_ms=p_ms,
                                                       library_ms=lib, bound_ms=bound, bound_by=by))
            torch.cuda.empty_cache()
        del qkv, heads, g, g4, ops
        torch.cuda.empty_cache()
        for name, rows_ in out.items():
            log(f"long rows {name}", json.dumps(rows_[-1]))
        log(f"long rows at B={B} L={L}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12 (--parallel): head-group shards of B1-B3 on the card, and the
# trainer across ranks through cli/main.py.

# (label, B, L, D, H, causal, shards n, dtypes): the shard widths Dv = D / n
# that ViT-B/16 and ViT-L/14 give at --mesh_model 2 and 4, at the training
# main path's batch for ViT-B/16 (256; L = 197 vision, 32 text) and a
# smaller one for ViT-L/14 (vision L = 257).  Dv = 192 (3 heads: ViT-B/16's
# vision tower and ViT-L/14's text tower at 4 shards) runs the GEMMs'
# 64-column tiles.
SHARD_CASES = [
    ("ViT-B/16 vision", 256, 197, 768, 12, False, 4, (torch.bfloat16,)),
    ("ViT-B/16 vision", 16, 197, 768, 12, False, 4, (torch.float32,)),
    ("ViT-L/14 text", 256, 32, 768, 12, True, 4, (torch.bfloat16,)),
    ("ViT-B/16 vision", 256, 197, 768, 12, False, 2, (torch.bfloat16,)),
    ("ViT-B/16 vision", 16, 197, 768, 12, False, 2, (torch.float32,)),
    ("ViT-B/16 text", 256, 32, 512, 8, True, 2, (torch.bfloat16,)),
    ("ViT-B/16 text", 256, 32, 512, 8, True, 4, (torch.bfloat16,)),
    ("ViT-B/16 text", 16, 32, 512, 8, True, 4, (torch.float32,)),
    ("ViT-L/14 vision", 32, 257, 1024, 16, False, 2, (torch.bfloat16,)),
    ("ViT-L/14 vision", 32, 257, 1024, 16, False, 4, (torch.bfloat16,)),
    ("ViT-L/14 text", 256, 32, 768, 12, True, 2, (torch.bfloat16,)),
]
# (label, M, D, Dv): the products whose columns a head shard of 3 or 5 heads
# makes an odd multiple of 64 (G1, G3, G4; G2 and G5 contract over Dv).
GEMM_SHARD_SHAPES = [("ViT-B/16 vision Dv 192", 256 * 197, 768, 192), ("ViT-L/14 text Dv 192", 256 * 32, 768, 192),
                     ("ViT-L/14 vision Dv 320", 32 * 257, 1024, 320)]


def shard_bound_ms(B, L, D, Dv, causal, dtype, peaks, kind):
    """(ms, "operations" | "bytes") of one shard launch.  Forward (B1, B3):
    QKV 6BLDDv + attention 4BL^2Dv (halved when causal) + out-projection
    2BLDvD; bytes x read, the fp32 partial written, the shard's weights
    read (B1 also writes q, k, v, o and lse).  Backward (B2): 16BLDDv +
    10BL^2Dv; x, g, o, q, k, v read, dx written, the weights and fp32
    grads."""
    el = torch.finfo(dtype).bits // 8
    attn = B * L * L * Dv * (0.5 if causal else 1.0)
    H = Dv // _HEAD_DIM
    if kind == "bwd":
        flops = 16 * B * L * D * Dv + 10 * attn
        nbytes = (3 * B * L * D + 4 * B * L * Dv) * el + B * L * H * 4 + 4 * D * Dv * el + (4 * D * Dv + 3 * Dv
                                                                                           + 3 * D) * 4
    else:
        flops = 8 * B * L * D * Dv + 4 * attn
        nbytes = B * L * D * el + B * L * D * 4 + 4 * D * Dv * el
        if kind == "fwd":
            nbytes += 4 * B * L * Dv * el + B * L * H * 4
    t_ops, t_bytes = flops / peaks[dtype], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def shard_weights(args, n, i):
    """Shard ``i`` of ``n`` of the block inputs: the heads' columns of Wqkv
    and bqkv, the rows of Wout; x, LN and bout whole."""
    x, ln_s, ln_b, wqkv, bqkv, wout, bout = args
    Dv = wqkv.shape[-1] // n
    cols = slice(i * Dv, (i + 1) * Dv)
    return (x, ln_s, ln_b, wqkv[:, :, cols].contiguous(), bqkv[:, cols].contiguous(), wout[cols].contiguous(), bout)


def phase_parallel_kernels(peaks) -> dict:
    """B3, B1 and B2 on head shards (partial / add_g=False) at every width
    of SHARD_CASES: each shard launch against its plain version, and the
    sum over the n shards (plus x + bout, or g) against the unsharded
    kernel; ms of one shard launch beside the plain version's and the
    unsharded launch's."""
    out = {"B3": [], "B1": [], "B2": []}
    for label, B, L, D, H, causal, n, dtypes in SHARD_CASES:
        for dtype in dtypes:
            Dv, Hl = D // n, H // n
            where = (label, B, L, D, Dv, n, str(dtype))
            args = block_inputs(B, L, D, dtype, seed=L + n)
            x, ln_s, ln_b, wqkv, _, wout, bout = args
            g = torch.randn(B, L, D, generator=torch.Generator().manual_seed(L + 7)).cuda().to(dtype)
            elem, norm, _ = BWD_TOL[dtype]
            common = dict(model=label, B=B, L=L, D=D, Dv=Dv, H=Hl, shards=n, causal=causal,
                          dtype=str(dtype).split(".")[-1])
            with torch.no_grad():
                full3 = ab._fwd_kernel_call(*args, H, causal, train=False)
                full1 = ab._fwd_kernel_call(*args, H, causal, train=True)
                full2 = ab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *full1[1:], H, causal)
                p3, p1, p2 = [], [], []
                errs = {"B3": 0.0, "B1": 0.0, "B2": 0.0}
                for i in range(n):
                    sa = shard_weights(args, n, i)
                    r3 = ab._fwd_kernel_call(*sa, Hl, causal, train=False, partial=True)
                    torch.cuda.synchronize()
                    errs["B3"] = max(errs["B3"], check_close(
                        "B3 shard", r3, ab.attention_block_inference_reference(*sa, Hl, causal, partial=True),
                        TOL[dtype], where))
                    r1 = ab._fwd_kernel_call(*sa, Hl, causal, train=True, partial=True)
                    torch.cuda.synchronize()
                    ref1 = ab.attention_block_reference(*sa, Hl, causal, partial=True)
                    for name, a, r in zip(("out", "o", "q", "k", "v"), r1, ref1):
                        e = check_close(f"B1 shard {name}", a, r, TOL[dtype], where)
                        errs["B1"] = max(errs["B1"], e) if name == "out" else errs["B1"]
                    check_close("B1 shard lse", r1[5], ref1[5], LSE_TOL[dtype], where, rtol=0.0)
                    r2 = ab._bwd_kernel_call(g, x, ln_s, ln_b, sa[3], sa[5], *r1[1:], Hl, causal, add_g=False)
                    torch.cuda.synchronize()
                    ref2 = ab.attention_block_backward_reference(g, x, ln_s, ln_b, sa[3], sa[5], *r1[1:], Hl, causal,
                                                                 add_g=False)
                    errs["B2"] = max(errs["B2"], check_close("B2 shard dx", r2[0], ref2[0], elem, where))
                    rels = [rel_norm(a, r) for a, r in zip(r2[1:], ref2[1:])]
                    if max(rels) > norm:
                        raise AssertionError(f"B2 shard sums disagree at {where}: {rels}")
                    p3.append(r3)
                    p1.append(r1)
                    p2.append(r2)
                # The shards summed as the TP wrapper sums them, against the
                # unsharded kernel.
                sum3 = ((x.float() + sum(p3)) + bout.float()).to(dtype)
                sum1 = ((x.float() + sum(r[0] for r in p1)) + bout.float()).to(dtype)
                dx = (g.float() + sum(r[0].float() for r in p2)).to(dtype)
                sums = {"B3": check_close("B3 shard sum", sum3, full3, TOL[dtype], where),
                        "B1": check_close("B1 shard sum", sum1, full1[0], TOL[dtype], where),
                        "B2": check_close("B2 shard sum dx", dx, full2[0], elem, where)}
                sum_rels = [rel_norm(sum(r[1] for r in p2), full2[1]), rel_norm(sum(r[2] for r in p2), full2[2]),
                            rel_norm(torch.cat([r[3] for r in p2], dim=-1), full2[3]),
                            rel_norm(torch.cat([r[4] for r in p2], dim=-1), full2[4])]
                if max(sum_rels) > norm:
                    raise AssertionError(f"B2 shard sums against the unsharded kernel at {where}: {sum_rels}")
                sa = shard_weights(args, n, 0)
                lse0 = p1[0]
                times = {
                    "B3": (cuda_ms(lambda: ab._fwd_kernel_call(*sa, Hl, causal, train=False, partial=True)),
                           cuda_ms(lambda: ab.attention_block_inference_reference(*sa, Hl, causal, partial=True),
                                   iters=5, warmup=1),
                           cuda_ms(lambda: ab._fwd_kernel_call(*args, H, causal, train=False))),
                    "B1": (cuda_ms(lambda: ab._fwd_kernel_call(*sa, Hl, causal, train=True, partial=True)),
                           cuda_ms(lambda: ab.attention_block_reference(*sa, Hl, causal, partial=True), iters=5,
                                   warmup=1),
                           cuda_ms(lambda: ab._fwd_kernel_call(*args, H, causal, train=True))),
                    "B2": (cuda_ms(lambda: ab._bwd_kernel_call(g, x, ln_s, ln_b, sa[3], sa[5], *lse0[1:], Hl, causal,
                                                               add_g=False)),
                           cuda_ms(lambda: ab.attention_block_backward_reference(
                               g, x, ln_s, ln_b, sa[3], sa[5], *lse0[1:], Hl, causal, add_g=False), iters=5,
                               warmup=1),
                           cuda_ms(lambda: ab._bwd_kernel_call(g, x, ln_s, ln_b, wqkv, wout, *full1[1:], H, causal))),
                }
            for kernel, kind in (("B3", "infer"), ("B1", "fwd"), ("B2", "bwd")):
                ms, plain_ms, whole_ms = times[kernel]
                bound, by = shard_bound_ms(B, L, D, Dv, causal, dtype, peaks, kind)
                case = dict(common, max_abs_err=errs[kernel], sum_max_abs_err=sums[kernel], ms=ms, plain_ms=plain_ms,
                            unsharded_ms=whole_ms, bound_ms=bound, bound_by=by, launches_per_case=n)
                out[kernel].append(case)
                log(f"{kernel} shard", json.dumps(case))
            del full1, full2, full3, p1, p2, p3
    out["gemm"] = [gemm_case(name, label, M, D, peaks, Dv) for label, M, D, Dv in GEMM_SHARD_SHAPES
                   for name in gs.PRODUCTS]
    torch.cuda.empty_cache()
    return out


# The TP blocks of phase 12: a full-width ViT-B/16 vision block in bf16,
# tensor-parallel on each opt-in route over 2 ranks, and on the default
# fused route over 4 (Dv = 192), held to the same block whole on one rank.
# Each rank launches per block forward and backward exactly what the whole
# block launches: B5 or B6 on its local heads, B1/B2 on its head shard, and
# B4 whole on the gathered MLP weights.
TP_BLOCK = (256, 197, 768, 12)  # B, L, D, heads
TP_BLOCK_ROUTES = (("pallas_qkv", 2), ("pallas", 2), ("pallas_block_mlp", 2), ("pallas_block", 4))
TP_BLOCK_LAUNCHES = {"pallas_qkv": {"B5_fwd": 1, "B5_bwd": 1}, "pallas": {"B6_fwd": 1, "B6_bwd": 1},
                     "pallas_block_mlp": {"B1": 1, "B2": 1, "B4": 1}, "pallas_block": {"B1": 1, "B2": 1}}
TP_BLOCK_WORLD = 4


def tp_block_case(seed: int = 0):
    """The seeded block (its own initialisers, biases and LN parameters
    then moved off their constants so every gradient is exercised) in
    training mode on the card, and its bf16 input and cotangent."""
    from flyp_tpu_torch.models.layers import ResidualBlock

    B, L, D, H = TP_BLOCK
    gen = torch.Generator().manual_seed(seed)
    block = ResidualBlock(D, H)
    with torch.no_grad():
        for m in block.modules():
            if hasattr(m, "reset_parameters") and m is not block:
                m.reset_parameters(gen)
        for name, p in block.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    block = block.cuda().train()
    x = torch.randn(B, L, D, generator=gen).to(torch.bfloat16).cuda()
    cot = torch.randn(B, L, D, generator=gen).to(torch.bfloat16).cuda()
    return block, x, cot


def tp_block_grads(block, x, cot):
    """Output and the grads of x and of every parameter, on the host."""
    x = x.clone().requires_grad_(True)
    names = [n for n, _ in block.named_parameters()]
    out = block(x)
    grads = torch.autograd.grad(out, [x, *block.parameters()], cot)
    torch.cuda.synchronize()
    return out.detach().cpu(), {"x": grads[0].cpu(), **{n: g.cpu() for n, g in zip(names, grads[1:])}}


def tp_blocks_rank(rank: int, world: int, port: int, out_dir: str):
    """One rank of the TP blocks: each route of TP_BLOCK_ROUTES on a
    (model = n, data = world / n) mesh of one gloo group on card 0 (the
    data axis repeats the block); the ranks at data 0 write their output,
    grads, layout and launches."""
    import datetime

    import torch.distributed as dist

    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from flyp_tpu_torch.parallel.tp import shard_params

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        for impl, n in TP_BLOCK_ROUTES:
            use_impl(impl)
            mesh = create_mesh(MeshConfig(model=n, data=world // n))
            block, x, cot = tp_block_case()
            layout = shard_params(mesh, block)
            reset_counts()
            t0 = time.perf_counter()
            out, grads = tp_block_grads(block, x, cot)
            run_s = time.perf_counter() - t0
            launched = counts()
            if mesh.coords()["data"] == 0:
                torch.save({"out": out, "grads": grads, "layout": layout, "counts": launched, "run_s": run_s},
                           os.path.join(out_dir, f"tp_block_{impl}.rank{mesh.coords()['model']}.pt"))
            del block, x, cot, out, grads
            dist.barrier()
    finally:
        use_impl("auto")
        dist.destroy_process_group()


def phase_tp_blocks(root: str) -> dict:
    """The TP blocks (TP_BLOCK_ROUTES) on TP_BLOCK_WORLD gloo ranks of one
    card, each held to the same block whole in this process on the same
    route: the output, x's gradient and every parameter's gradient (the
    shards' joined along their sharded dim) within a relative norm of 1e-2
    (the phase's bf16 rule for sums: a TP rank rounds its partial products
    before they are summed, so single elements of the output differ from
    the whole block's by a few bf16 ulps where the block's products cancel
    the residual); every rank's launches the whole block's, exactly."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(root, "tp_blocks")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.start_processes(tp_blocks_rank, args=(TP_BLOCK_WORLD, _free_port(), out_dir), nprocs=TP_BLOCK_WORLD,
                       join=True, start_method="spawn")
    res = {"ranks_s": time.perf_counter() - t0, "routes": {}}
    for impl, n in TP_BLOCK_ROUTES:
        use_impl(impl)
        block, x, cot = tp_block_case()
        reset_counts()
        want_out, want = tp_block_grads(block, x, cot)
        whole = counts()
        del block, x, cot
        expected = {k: 0 for k in whole}
        expected.update(TP_BLOCK_LAUNCHES[impl])
        if whole != expected:
            raise AssertionError(f"TP block {impl}: the whole block launched {whole}, expected {expected}")
        shards = [torch.load(os.path.join(out_dir, f"tp_block_{impl}.rank{i}.pt")) for i in range(n)]
        where = ("TP block", impl, n, TP_BLOCK)
        for i, sh in enumerate(shards):
            if sh["counts"] != expected:
                raise AssertionError(f"TP block {impl} rank {i}: launches {sh['counts']}, expected {expected}")
        layout = shards[0]["layout"]
        errs = {"out": float((shards[0]["out"].float() - want_out.float()).abs().max()),
                "x": float((shards[0]["grads"]["x"].float() - want["x"].float()).abs().max())}
        if not all(bool(torch.isfinite(t).all()) for t in (shards[0]["out"], shards[0]["grads"]["x"])):
            raise AssertionError(f"TP block {impl}: non-finite output or dx at {where}")
        rels = {"out": rel_norm(shards[0]["out"], want_out)}
        for name, ref in want.items():
            got = (torch.cat([sh["grads"][name] for sh in shards], dim=layout[name][1]) if name in layout
                   else shards[0]["grads"][name])
            rels[name] = rel_norm(got, ref)
        worst = max(rels, key=rels.get)
        if rels[worst] > BWD_TOL[torch.bfloat16][1]:
            raise AssertionError(f"TP block {impl}: {worst} at relative norm {rels[worst]} from the whole "
                                 f"block's (bound {BWD_TOL[torch.bfloat16][1]}): {rels}")
        res["routes"][impl] = {"shards": n, "launches_per_rank": shards[0]["counts"], "max_abs_err": errs,
                               "rel_norm": rels, "sharded": sorted(layout),
                               "rank_fwd_bwd_s": [sh["run_s"] for sh in shards]}
        log(f"TP block {impl} over {n} ranks: output at {rels['out']:.3g} of the whole block's norm (max abs "
            f"{errs['out']:.4g}), dx max abs {errs['x']:.4g}, worst {worst} at {rels[worst]:.3g}; launches a rank "
            f"{ {k: v for k, v in shards[0]['counts'].items() if v} }")
    use_impl("auto")
    return res


def gloo_cuda_collectives() -> dict:
    """Which collectives this torch build's gloo takes for CUDA tensors, on a
    one-rank gloo group in this process.  ``parallel/comm.py`` hands gloo
    its CUDA tensors as they lie, so the one-card runs need every one."""
    import torch.distributed as dist

    res = {}
    store = dist.HashStore()
    pg = dist.ProcessGroupGloo(store, 0, 1) if hasattr(dist, "ProcessGroupGloo") else None
    if pg is None:
        return {"probe": "no ProcessGroupGloo"}
    t = torch.ones(4, device="cuda")
    ops = {
        "all_reduce": lambda: pg.allreduce([t]).wait(),
        "broadcast": lambda: pg.broadcast([t]).wait(),
        "all_gather": lambda: pg.allgather([[torch.empty_like(t)]], [t]).wait(),
        "reduce_scatter": lambda: pg.reduce_scatter([torch.empty_like(t)], [[t]]).wait(),
    }
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = True
        except Exception as e:  # recorded, then refused below with every answer
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if any(v is not True for v in res.values()):
        raise AssertionError(f"gloo does not take CUDA tensors for every collective the port calls: {res}")
    return res


# The multi-rank trainer runs: ViT-B/16 at full width, bf16, bf16 moments,
# batch 256 of the input phase's corpus, PARALLEL_STEPS steps a run from the
# seed-0 weights at PARALLEL_LR from the first step (no warm-up, so every
# step moves the model), the global gradient norm logged, saved at the end
# (a step checkpoint); FSDP also stopped after PARALLEL_STOP steps and
# resumed to PARALLEL_STEPS.  PARALLEL_FAULT is data parallelism with the
# gradient sum over ranks skipped: each rank steps on its own rows' share,
# which every bound below must refuse.
PARALLEL_STEPS, PARALLEL_STOP = 4, 2
PARALLEL_LR = "1e-4"
PARALLEL_LAYOUTS = {"dp": (), "tp": ("--mesh_model", "2"), "fsdp": ("--fsdp",)}
PARALLEL_FAULT = "dp_no_grad_sum"
# Against the one-process run, from the spread of sound runs on one H100
# (PERF.md's phase 12 findings: the largest, TP's, beside the planted
# fault's); the fault must exceed each.
PARALLEL_LOSS_TOL = 5e-3  # per-step loss, relative (TP 5.05e-4; fault 0.129)
PARALLEL_GRAD_NORM_TOL = 5e-2  # per-step global gradient norm, relative (TP 8.17e-3; fault 3.85)
PARALLEL_PARAM_TOL = 0.3  # |p - p_single| / |p_single - p_init| over every parameter (TP 0.094; fault 1.14)


# RN50 across ranks: the same command at --model RN50, directly and with
# --grad_cache_chunks 2, in one process and as data parallelism; the
# planted fault normalises each rank's rows by their own statistics (the
# BatchNorm all-reduces skipped).  Against the one-process run of the same
# command as the ViT runs are, and the running statistics bit-equal on
# every rank and, as a share of the one-process run's own movement from
# their initial values, within PARALLEL_RN_STATS_TOL of its.  A random-init
# RN50 in bf16 amplifies rounding (PERF.md, Findings): the sound runs' later
# steps and final parameters drift far from the one-process run's (Adam's
# sign-like first steps flip the near-zero gradients), so the bounds come
# from the measured spread (PERF.md, Findings: the sound runs' step-0 loss
# 6.0e-5 and 4.6e-5, every step 2.9e-3, gradient norms 0.18, parameters
# 0.68, statistics 0.087; the fault's step-0 loss 4.4e-4), and the step-0
# loss, at equal weights, is the tight one.
PARALLEL_RN_RUNS = {"rn_dp": ("rn_single", ()), "rn_chunk_dp": ("rn_chunk_single", ("--grad_cache_chunks", "2"))}
PARALLEL_RN_FAULT = "rn_dp_local_bn"
PARALLEL_RN_LOSS0_TOL = 2e-4  # the first step's loss, relative
PARALLEL_RN_LOSS_TOL = 1e-2  # per-step loss, relative
PARALLEL_RN_GRAD_NORM_TOL = 0.5  # per-step global gradient norm, relative
PARALLEL_RN_PARAM_TOL = 1.5  # as PARALLEL_PARAM_TOL
PARALLEL_RN_STATS_TOL = 0.3  # |s - s_single| / |s_single - s_init| over every running statistic


def parallel_argv(tsv: str, root: str, name: str, steps: int, workers: int, model: str = MODEL) -> list:
    return ["--ft_data", tsv, "--batch-size", str(INPUT_BATCH), "--data_backend", "native", "--workers",
            str(workers), "--model", model, "--seed", "0", "--epochs", "1", "--lr", PARALLEL_LR,
            "--warmup_length", "0", "--log_grad_norm", "--adam_moment_dtype", "bfloat16", "--max_steps",
            str(steps), "--save", os.path.join(root, name), "--exp_name", name]


class _LocalBatchNorm:
    """A planted fault: BatchNorm ignores the group the step gives it, so
    each rank normalises by its own rows' statistics."""

    def __get__(self, obj, owner=None):
        return None

    def __set__(self, obj, value):
        pass


def _planted(name: str, fn):
    """``fn()``, with the gradient sum over ranks skipped if ``name`` is
    the planted fault's run, or BatchNorm's all-reduces if it is the RN
    fault's."""
    from flyp_tpu_torch.models import resnet
    from flyp_tpu_torch.parallel import comm

    if name == PARALLEL_RN_FAULT:
        resnet.TorchBatchNorm.group = _LocalBatchNorm()
        try:
            return fn()
        finally:
            resnet.TorchBatchNorm.group = None
    if name != PARALLEL_FAULT:
        return fn()
    real = comm.all_reduce_flat
    comm.all_reduce_flat = lambda tensors, group, *a, **k: [t.clone() for t in tensors]
    try:
        return fn()
    finally:
        comm.all_reduce_flat = real


def _rank_counts(out_dir: str, rank: int, name: str, fn):
    """Run ``fn`` (a trainer run) with every count at 0 and each step's
    start stamped (after a synchronise); write this rank's launches, the
    run's return value and its step intervals.  For a ModifiedResNet, also
    this rank's running statistics after the run and the BatchNorm
    all-reduces it called; for a chunked run, the host seconds of its
    chunk re-layout (synchronised before and after)."""
    from flyp_tpu_torch.models import resnet
    from flyp_tpu_torch.training import flyp, grad_cache

    stamps, models = [], []
    bn_calls, relayout_s = [0], [0.0]
    real = flyp.make_train_step, resnet.all_reduce_, grad_cache.chunk_rows

    def make_step(*args, **kwargs):
        models.append(args[0])
        step = real[0](*args, **kwargs)

        def stamped(*a, **k):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return step(*a, **k)
        return stamped

    def bn_all_reduce(*a, **k):
        bn_calls[0] += 1
        return real[1](*a, **k)

    def timed_relayout(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real[2](*a, **k)
        torch.cuda.synchronize()
        relayout_s[0] += time.perf_counter() - t0
        return res

    flyp.make_train_step, resnet.all_reduce_, grad_cache.chunk_rows = make_step, bn_all_reduce, timed_relayout
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        flyp.make_train_step, resnet.all_reduce_, grad_cache.chunk_rows = real
    record = {"counts": counts(), "ret": res, "run_s": time.perf_counter() - t0,
              "step_intervals_ms": [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])],
              "steps": len(stamps), "bn_all_reduces": bn_calls[0], "relayout_s": relayout_s[0]}
    if models and not models[0].config.vision.is_vit:
        torch.save({k: v.detach().cpu() for k, v in models[0].named_buffers()},
                   os.path.join(out_dir, f"{name}.rank{rank}.stats.pt"))
    with open(os.path.join(out_dir, f"{name}.rank{rank}.json"), "w") as f:
        json.dump(record, f)
    return res


def _tp_head(out_dir: str, rank: int, ckpt: str):
    """The epoch-end head of a TP run: the zero-shot head of ``ckpt`` built
    by the model sharded over a model axis of 2 (B3 on each rank's heads,
    one launch a text block) against the head of the whole model (B3
    whole); the least cosine of a class's row."""
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from flyp_tpu_torch.parallel.tp import shard_params

    cfg = SimpleNamespace(model=MODEL, clip_load=ckpt, compute_dtype="bfloat16", seed=0)
    whole = get_zeroshot_classifier(build_clip_model(cfg, device="cuda"), CLASSNAMES, simple_template)
    model = build_clip_model(cfg, device="cuda")
    shard_params(create_mesh(MeshConfig(model=2)), model)
    reset_counts()
    head = get_zeroshot_classifier(model, CLASSNAMES, simple_template)
    torch.cuda.synchronize()
    got, ref = head.weight.float().cpu(), whole.weight.float().cpu()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=1)
    with open(os.path.join(out_dir, f"tp_head.rank{rank}.json"), "w") as f:
        json.dump({"counts": counts(), "min_cos": float(cos.min())}, f)


def parallel_gloo_rank(rank: int, world: int, port: int, runs: list, out_dir: str, cwd: str):
    """One rank of the one-card runs: a gloo group, both ranks on card 0,
    each run of ``runs`` through cli/main.py in turn."""
    import datetime

    import torch.distributed as dist

    from flyp_tpu_torch.cli import main as cli_main

    os.chdir(cwd)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        use_impl("auto")
        with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
            for name, argv in runs:
                ret = _rank_counts(out_dir, rank, name, lambda: _planted(
                    name, lambda: cli_main.main(cli_main.parse_main_arguments(argv))))
                if name == "tp":
                    _tp_head(out_dir, rank, ret)
    finally:
        dist.destroy_process_group()


def run_metrics(cwd: str, name: str) -> tuple:
    """The per-step losses and global gradient norms a run's rank 0 logged
    (metrics.jsonl)."""
    base = os.path.join(cwd, "expt_logs", name)
    (key,) = os.listdir(base)
    with open(os.path.join(base, key, "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "ID FLYP Loss" in r]
    return [r["ID FLYP Loss"] for r in steps], [r["Gradient Norm"] for r in steps]


def param_distance(path: str, ref: dict, init: dict) -> float:
    """|p - p_ref| / |p_ref - p_init| over every parameter of the checkpoint
    at ``path`` (fp32 norms): how far a run ended from the reference, as a
    share of how far the reference moved."""
    from flyp_tpu_torch.utils import checkpoint

    got = checkpoint.load_tensors(path)
    if sorted(got) != sorted(ref):
        raise AssertionError(f"{path}: parameter names differ from the one-process run's")
    off = sum(float((got[k].double() - ref[k].double()).pow(2).sum()) for k in ref)
    moved = sum(float((ref[k].double() - init[k].double()).pow(2).sum()) for k in ref)
    return math.sqrt(off / moved)


def _rel(got: list, want: list) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def phase_parallel(card: str, peaks, kernels: bool = True) -> dict:
    """Phase 12: the shard kernels (unless ``kernels`` is False), then the
    trainer across ranks, its ViT-B/16 at ``TRAINER_DEPTH`` (full width)."""
    out = _phase_parallel_kernels(card, peaks, kernels)
    with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
        return _phase_parallel_trainer(card, out)


def _phase_parallel_kernels(card: str, peaks, kernels: bool) -> dict:
    import gc

    t_phase = time.perf_counter()
    out = {"card": card, "kernels": phase_parallel_kernels(peaks) if kernels else None}
    gc.collect()
    torch.cuda.empty_cache()
    out["gloo_cuda_collectives"] = gloo_cuda_collectives()
    log(f"parallel: gloo takes CUDA tensors for {out['gloo_cuda_collectives']}")
    if kernels:
        with tempfile.TemporaryDirectory() as root:
            out["tp_blocks"] = phase_tp_blocks(root)
        gc.collect()
        torch.cuda.empty_cache()
    out["t_phase"] = t_phase
    return out


def _phase_parallel_trainer(card: str, out: dict) -> dict:
    import gc

    import torch.multiprocessing as mp

    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.utils import checkpoint

    t_phase = out.pop("t_phase")
    cards = torch.cuda.device_count()
    world = min(cards, 4) if cards >= 2 else 2
    backend = "nccl" if cards >= 2 else "gloo"
    cwd = os.getcwd()
    _, layers_v, layers_t = model_shape()
    with tempfile.TemporaryDirectory() as root:
        tsv, _, _, corpus_s = trainer_corpus(0)
        log(f"parallel: corpus in {corpus_s:.1f} s")
        runs_dir = os.path.join(root, "runs")
        os.makedirs(runs_dir)
        workers = max(1, (os.cpu_count() or 2) // world)
        # The reference: one process through torchrun, over nccl (world 1).
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        ref_argv = parallel_argv(tsv, root, "single", PARALLEL_STEPS, INPUT_WORKERS)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
                        "--master_port", str(_free_port()), os.path.abspath(__file__), "--parallel-rank", runs_dir,
                        "single", json.dumps(ref_argv)], cwd=runs_dir, env=env, check=True, timeout=400)
        out["single_s"] = time.perf_counter() - t0
        ref, ref_norms = run_metrics(runs_dir, "single")
        with open(os.path.join(runs_dir, "single.rank0.json")) as f:
            single = json.load(f)
        want = {k: 0 for k in single["counts"]}
        want.update(B1=(layers_v + layers_t) * PARALLEL_STEPS, B2=(layers_v + layers_t) * PARALLEL_STEPS)
        if single["counts"] != want:
            raise AssertionError(f"parallel single: launches {single['counts']}, expected {want}")
        out["single_step_ms"] = sorted(single["step_intervals_ms"])[len(single["step_intervals_ms"]) // 2]
        log(f"parallel: world 1 over nccl (torchrun): losses {ref}, gradient norms {ref_norms} in "
            f"{out['single_s']:.1f} s")
        ran = [{"world": 1, "backend": "nccl", "layout": "single process"}]
        runs = []
        for name, flags in PARALLEL_LAYOUTS.items():
            runs.append((name, [*parallel_argv(tsv, root, name, PARALLEL_STEPS, workers), *flags]))
        runs.append(("fsdp_stop", [*parallel_argv(tsv, root, "fsdp_resume", PARALLEL_STOP, workers), "--fsdp"]))
        runs.append(("fsdp_resume", [*parallel_argv(tsv, root, "fsdp_resume", PARALLEL_STEPS - PARALLEL_STOP,
                                                     workers), "--fsdp"]))
        runs.append((PARALLEL_FAULT, parallel_argv(tsv, root, PARALLEL_FAULT, PARALLEL_STEPS, workers)))
        for name, (_, flags) in PARALLEL_RN_RUNS.items():
            runs.append((name, [*parallel_argv(tsv, root, name, PARALLEL_STEPS, workers, RN_MODEL), *flags]))
        runs.append((PARALLEL_RN_FAULT, parallel_argv(tsv, root, PARALLEL_RN_FAULT, PARALLEL_STEPS, workers,
                                                      RN_MODEL)))
        # The RN references: one process, in this one (no process group).
        t0 = time.perf_counter()
        os.chdir(runs_dir)  # cli/main.py writes expt_logs/ under the working directory
        try:
            for ref_name, flags in PARALLEL_RN_RUNS.values():
                rn_argv = [*parallel_argv(tsv, root, ref_name, PARALLEL_STEPS, INPUT_WORKERS, RN_MODEL), *flags]
                _rank_counts(runs_dir, 0, ref_name, lambda: cli_main.main(cli_main.parse_main_arguments(rn_argv)))
        finally:
            os.chdir(cwd)
        out["rn_single_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if backend == "nccl":
            for name, argv in runs:
                subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
                                "--master_port", str(_free_port()), os.path.abspath(__file__),
                                "--parallel-rank", runs_dir, name, json.dumps(argv)],
                               cwd=runs_dir, env=env, check=True, timeout=300)
        else:
            mp.start_processes(parallel_gloo_rank, args=(world, _free_port(), runs, runs_dir, runs_dir),
                               nprocs=world, join=True, start_method="spawn")
        out["runs_s"] = time.perf_counter() - t0
        results = {}
        for name, _ in runs:
            per_rank = []
            for r in range(world):
                with open(os.path.join(runs_dir, f"{name}.rank{r}.json")) as f:
                    per_rank.append(json.load(f))
            results[name] = per_rank
        for ref_name, _ in PARALLEL_RN_RUNS.values():
            with open(os.path.join(runs_dir, f"{ref_name}.rank0.json")) as f:
                results[ref_name] = [json.load(f)]
        rn_layers_t = MODEL_CONFIGS[RN_MODEL].text.layers
        out["step_ms"] = {name: [sorted(r["step_intervals_ms"])[len(r["step_intervals_ms"]) // 2]
                                 for r in res if r["step_intervals_ms"]] for name, res in results.items()}
        out["run_s"] = {name: [r["run_s"] for r in res] for name, res in results.items()}
        log(f"parallel: median ms between step starts {out['step_ms']}; run seconds {out['run_s']}")
        for name, res in results.items():
            steps = PARALLEL_STOP if name == "fsdp_stop" else (
                PARALLEL_STEPS - PARALLEL_STOP if name == "fsdp_resume" else PARALLEL_STEPS)
            for r, rec in enumerate(res):
                c = rec["counts"]
                # Each rank launches B1 and B2 once a block a step (a TP
                # rank on its heads), and nothing else; RN50 in its text
                # tower alone, and the chunked step B1 twice (features,
                # then gradients) and B2 once a chunk.
                want = {k: 0 for k in c}
                if name.startswith("rn_chunk"):
                    want.update(B1=rn_layers_t * 4 * steps, B2=rn_layers_t * 2 * steps)
                elif name.startswith("rn_"):
                    want.update(B1=rn_layers_t * steps, B2=rn_layers_t * steps)
                else:
                    want.update(B1=(layers_v + layers_t) * steps, B2=(layers_v + layers_t) * steps)
                if c != want:
                    raise AssertionError(f"parallel {name} rank {r}: launches {c}, expected {want}")
        # Each run against the one-process run: per-step losses and global
        # gradient norms, and the final parameters as a share of the
        # reference's own movement from the seed-0 weights (built on the
        # CPU, as the trainer builds them before moving them to its card).
        ref_params = checkpoint.load_tensors(results_path(root, "single"))
        init = {k: v.detach() for k, v in build_clip_model(
            SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="bfloat16", seed=0),
            device="cpu").named_parameters()}
        moved_rms = math.sqrt(sum(float((ref_params[k].double() - init[k].double()).pow(2).sum())
                                  for k in ref_params) / sum(v.numel() for v in ref_params.values()))
        # Adam moves a parameter by about the learning rate a step: a far
        # larger movement means another starting point than the trainer's.
        if not 0 < moved_rms < PARALLEL_STEPS * float(PARALLEL_LR):
            raise AssertionError(f"parallel: the one-process run moved its parameters by {moved_rms:.3g} rms in "
                                 f"{PARALLEL_STEPS} steps at lr {PARALLEL_LR}")
        out["single_losses"], out["single_grad_norms"], out["single_moved_rms"] = ref, ref_norms, moved_rms
        checks = {}
        for name in [*PARALLEL_LAYOUTS, PARALLEL_FAULT]:
            losses, norms = run_metrics(runs_dir, name)
            if len(losses) != len(ref) or len(norms) != len(ref_norms):
                raise AssertionError(f"parallel {name}: {len(losses)} steps logged, expected {len(ref)}")
            checks[name] = {"losses": losses, "grad_norms": norms, "loss_rel_err": _rel(losses, ref),
                            "grad_norm_rel_err": _rel(norms, ref_norms),
                            "param_distance": param_distance(results_path(root, name), ref_params, init)}
            c = checks[name]
            log(f"parallel: {name} over {backend}, world {world}: losses {losses} (rel err "
                f"{max(c['loss_rel_err']):.3g}), gradient norms {norms} (rel err {max(c['grad_norm_rel_err']):.3g}), "
                f"parameters {c['param_distance']:.4g} of the one-process run's movement ({moved_rms:.3g} rms)")
        out["checks"] = checks
        for name in PARALLEL_LAYOUTS:
            c = checks[name]
            if (max(c["loss_rel_err"]) > PARALLEL_LOSS_TOL or max(c["grad_norm_rel_err"]) > PARALLEL_GRAD_NORM_TOL
                    or c["param_distance"] > PARALLEL_PARAM_TOL):
                raise AssertionError(f"parallel {name} against the one-process run: {c} (bounds: loss "
                                     f"{PARALLEL_LOSS_TOL}, gradient norm {PARALLEL_GRAD_NORM_TOL}, parameters "
                                     f"{PARALLEL_PARAM_TOL})")
            ran.append({"world": world, "backend": backend, "layout": name})
        c = checks[PARALLEL_FAULT]
        if (max(c["loss_rel_err"]) <= PARALLEL_LOSS_TOL or max(c["grad_norm_rel_err"]) <= PARALLEL_GRAD_NORM_TOL
                or c["param_distance"] <= PARALLEL_PARAM_TOL):
            raise AssertionError(f"parallel: the planted fault ({PARALLEL_FAULT}) passes a bound: {c}")
        log(f"parallel: the planted fault ({PARALLEL_FAULT}) fails every bound: loss rel err "
            f"{max(c['loss_rel_err']):.3g} > {PARALLEL_LOSS_TOL}, gradient norm rel err "
            f"{max(c['grad_norm_rel_err']):.3g} > {PARALLEL_GRAD_NORM_TOL}, parameters {c['param_distance']:.4g} > "
            f"{PARALLEL_PARAM_TOL}")
        out["rn"] = rn_parallel_checks(root, runs_dir, results, world, backend)
        out["rn"]["synced_bn_one_rank"] = rn_synced_bn_check()
        ran += [{"world": world, "backend": backend, "layout": name} for name in PARALLEL_RN_RUNS]
        # The TP run's head: B3 on each rank's heads, one launch a text block.
        _, _, layers_t = model_shape()
        heads = []
        for r in range(world):
            with open(os.path.join(runs_dir, f"tp_head.rank{r}.json")) as f:
                heads.append(json.load(f))
            want = {k: 0 for k in heads[-1]["counts"]}
            want["B3"] = layers_t
            if heads[-1]["counts"] != want or heads[-1]["min_cos"] < 0.99:
                raise AssertionError(f"parallel tp head rank {r}: {heads[-1]} (expected launches {want}, cosine "
                                     ">= 0.99)")
        out["tp_head"] = heads
        log(f"parallel: the TP run's zero-shot head on 2 model ranks: least cosine "
            f"{min(h['min_cos'] for h in heads):.6f} to the whole model's, B3 {layers_t} a rank")
        # Checkpoints: whole shapes, written once, the same layout resuming
        # bit for bit.
        single_ckpt = results_path(root, "single")
        shapes = {k: tuple(v.shape) for k, v in checkpoint.load_tensors(single_ckpt).items()}
        for name in PARALLEL_LAYOUTS:
            got = {k: tuple(v.shape) for k, v in checkpoint.load_tensors(results_path(root, name)).items()}
            if got != shapes:
                raise AssertionError(f"parallel {name}: the checkpoint's shapes are not the whole model's")
        out["fsdp_resume_bytes"] = checkpoint_equal(results_path(root, "fsdp"), results_path(root, "fsdp_resume"),
                                                    "parallel fsdp resume")
        out["ran"] = ran
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel: ran {ran}; FSDP resumed bit-equal; phase took {out['phase_s']:.1f} s on {card}")
    return out


def rn_synced_bn_check() -> dict:
    """The synchronised BatchNorm on the card, in one process over a gloo
    group of one rank (the all-reduces run, the numbers are this rank's):
    one RN50 step's loss and gradients at B = 256 against the same step on
    cuDNN's BatchNorm, and on ATen's (cuDNN off), the spread of two torch
    implementations of the same BatchNorm.  fp32 holds the synchronised
    step to cuDNN's at 1e-5 (loss) and a gradient cosine of 0.99 (the
    exact-zero ``ZERO_GRADS`` aside; in bf16 hundreds of its tensors fall
    below that between cuDNN's and ATen's BatchNorm); bf16 is recorded only: there a
    random-init RN50 carries each rounding difference into whole
    gradients."""
    import datetime

    import torch.distributed as dist

    from flyp_tpu_torch.models import resnet

    images, tokens = bench_batch(INPUT_BATCH, MODEL_CONFIGS[RN_MODEL].vision.image_size, seed=1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        group = dist.new_group([0])
        for dtype in ("float32", "bfloat16"):
            model = build_clip_model(rn_cfg(dtype), device="cuda").train().requires_grad_(True)
            names = [n for n, _ in model.named_parameters()]
            im = torch.from_numpy(images).cuda().to(getattr(torch, dtype))
            tk = torch.from_numpy(tokens).cuda()
            runs = {}
            for name in ("cudnn", "aten", "synced"):
                torch.backends.cudnn.enabled = name != "aten"
                try:
                    with resnet.synced_batch_norm(model, group if name == "synced" else None), \
                            resnet.running_stats_frozen(model):
                        runs[name] = loss_and_grads(model, im, tk)
                finally:
                    torch.backends.cudnn.enabled = True
            ref_loss, ref_grads = runs["cudnn"]
            for name in ("aten", "synced"):
                loss, grads = runs[name]
                cos = grad_cosines([g for n, g in zip(names, grads) if n not in ZERO_GRADS],
                                   [g for n, g in zip(names, ref_grads) if n not in ZERO_GRADS])
                out[f"{dtype} {name}"] = {"loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                                          "min_grad_cosine": min(cos), "params_below_0.99": sum(c < 0.99 for c in cos)}
            del model, runs
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    f32 = out["float32 synced"]
    if f32["loss_rel_err"] > 1e-5 or f32["min_grad_cosine"] < 0.99:
        raise AssertionError(f"the synchronised BatchNorm's fp32 RN50 step against cuDNN's: {f32}")
    log(f"parallel: the synchronised BatchNorm's RN50 step (B = {INPUT_BATCH}, one rank) against cuDNN's: {out}")
    return out


def stats_distance(stats: dict, ref: dict, init: dict) -> float:
    """|s - s_ref| / |s_ref - s_init| over every running statistic."""
    off = sum(float((stats[k].double() - ref[k].double()).pow(2).sum()) for k in ref)
    moved = sum(float((ref[k].double() - init[k].double()).pow(2).sum()) for k in ref)
    return math.sqrt(off / moved)


def rn_parallel_checks(root: str, runs_dir: str, results: dict, world: int, backend: str) -> dict:
    """RN50 across ranks against its one-process runs (PARALLEL_RN_RUNS):
    per-step losses, global gradient norms, final parameters and running
    statistics within PARALLEL_RN_*_TOL, the statistics bit-equal on every
    rank; the planted fault (PARALLEL_RN_FAULT) must fail at least one of
    those checks.  Also the BatchNorm all-reduces a step and the chunk
    re-layout's seconds."""
    from flyp_tpu_torch.utils import checkpoint

    cfg = SimpleNamespace(model=RN_MODEL, clip_load=None, compute_dtype="bfloat16", seed=0)
    start = build_clip_model(cfg, device="cpu")
    init = {k: v.detach() for k, v in start.named_parameters()}
    init_stats = {k: v.detach() for k, v in start.named_buffers()}
    del start

    def stats(name, r):
        return torch.load(os.path.join(runs_dir, f"{name}.rank{r}.stats.pt"))

    out = {}
    for name, ref_name in [*((n, ref) for n, (ref, _) in PARALLEL_RN_RUNS.items()),
                           (PARALLEL_RN_FAULT, PARALLEL_RN_RUNS["rn_dp"][0])]:
        ref, ref_norms = run_metrics(runs_dir, ref_name)
        losses, norms = run_metrics(runs_dir, name)
        if len(losses) != len(ref) or len(norms) != len(ref_norms):
            raise AssertionError(f"parallel {name}: {len(losses)} steps logged, expected {len(ref)}")
        ref_params = checkpoint.load_tensors(results_path(root, ref_name))
        ref_stats = stats(ref_name, 0)
        per_rank = [stats(name, r) for r in range(world)]
        equal = all(torch.equal(per_rank[0][k], other[k]) for other in per_rank[1:] for k in per_rank[0])
        recs = results[name]
        steps = recs[0]["steps"]
        c = {"losses": losses, "grad_norms": norms, "single_losses": ref, "single_grad_norms": ref_norms,
             "loss_rel_err": _rel(losses, ref), "grad_norm_rel_err": _rel(norms, ref_norms),
             "param_distance": param_distance(results_path(root, name), ref_params, init),
             "stats_distance": stats_distance(per_rank[0], ref_stats, init_stats), "stats_equal_on_ranks": equal,
             "bn_all_reduces_per_step": recs[0]["bn_all_reduces"] / steps,
             "relayout_ms_per_step": recs[0]["relayout_s"] * 1e3 / steps,
             "step_ms": sorted(recs[0]["step_intervals_ms"])[len(recs[0]["step_intervals_ms"]) // 2],
             "single_step_ms": sorted(results[ref_name][0]["step_intervals_ms"])[
                 len(results[ref_name][0]["step_intervals_ms"]) // 2]}
        c["fails"] = [k for k, bad in (
            ("loss0", c["loss_rel_err"][0] > PARALLEL_RN_LOSS0_TOL),
            ("loss", max(c["loss_rel_err"]) > PARALLEL_RN_LOSS_TOL),
            ("grad_norm", max(c["grad_norm_rel_err"]) > PARALLEL_RN_GRAD_NORM_TOL),
            ("params", c["param_distance"] > PARALLEL_RN_PARAM_TOL),
            ("stats", c["stats_distance"] > PARALLEL_RN_STATS_TOL),
            ("stats_equal_on_ranks", not equal)) if bad]
        out[name] = c
        log(f"parallel: {name} over {backend}, world {world}, against {ref_name}: losses {losses} against "
            f"{ref}, rel err {c['loss_rel_err']}; gradient norms {norms} against {ref_norms}, rel err "
            f"{c['grad_norm_rel_err']}; parameters "
            f"{c['param_distance']:.4g}, running statistics {c['stats_distance']:.4g} of the one-process run's "
            f"movement, bit-equal on the ranks: {equal}; BatchNorm all-reduces a step "
            f"{c['bn_all_reduces_per_step']:.1f}, re-layout {c['relayout_ms_per_step']:.2f} ms a step; ms between "
            f"step starts {c['step_ms']:.1f} (one process {c['single_step_ms']:.1f}); fails {c['fails']}")
    # BatchNorm's collectives: the fault's run skips exactly them.
    out["bn_collective_share_of_dp_step"] = 1 - out[PARALLEL_RN_FAULT]["step_ms"] / out["rn_dp"]["step_ms"]
    log(f"parallel: BatchNorm's all-reduces take {out['bn_collective_share_of_dp_step']:.3f} of the RN50 DP step "
        f"(its ms between step starts against the fault's, which skips them)")
    bad = {n: out[n]["fails"] for n in PARALLEL_RN_RUNS if out[n]["fails"]}
    if bad:
        raise AssertionError(f"parallel RN50 runs against their one-process runs fail {bad} (bounds: step-0 loss "
                             f"{PARALLEL_RN_LOSS0_TOL}, loss {PARALLEL_RN_LOSS_TOL}, gradient norm "
                             f"{PARALLEL_RN_GRAD_NORM_TOL}, parameters "
                             f"{PARALLEL_RN_PARAM_TOL}, statistics {PARALLEL_RN_STATS_TOL})")
    if not out[PARALLEL_RN_FAULT]["fails"]:
        raise AssertionError(f"parallel: the planted fault ({PARALLEL_RN_FAULT}) passes every check")
    return out


# Phase 13: the research trainers (ROADMAP A11) at full ViT-B/16 width, on a
# PatchCamelyon-shaped tree: two classes of 96-px PNGs in train, val, test
# and train_shot_16, and a guidance TSV over the train images at two
# guidance values (each caption names its class).
RESEARCH_PX = 96
RESEARCH_SPLITS = {"train": 64, "val": 32, "test": 64, "train_shot_16": 16}  # images a class
RESEARCH_GUIDANCE = (50, 100)
RESEARCH_BATCH = 32  # the CE ablation's and the beam search's batch, and every evaluation's
FEW_SHOT_K, FEW_SHOT_EPOCHS = 16, 4
FISHER_VIT_IMAGES, FISHER_RN_IMAGES = 16, 8
# The CE ablation's 2-rank runs compute in fp32: in bf16 a sound run's
# losses left one process's by 5.2e-3-6.8e-3 within 3 steps at lr 1e-5 and
# 1e-6 alike (PERF.md, phase 13), above phase 12's bound.
CE_RANK_DTYPE = "float32"
PROBE_CS = 20
# The Fisher of the card against the CPU port's on the same images and
# labels: the largest per-tensor ||F_card - F_cpu|| / ||F_cpu||.  ViT-B/16's
# from the spread of sound runs (PERF.md, phase 13: 1.22e-6); the RN's
# training-mode BatchNorm amplifies rounding (ROADMAP, "What the parity
# tests showed"), so it is held to SPREAD_FACTOR times the CPU's own spread
# (one thread against all), no tighter than its floor here.  The planted
# fault (the square of the batch-summed gradient) must exceed the bound.
FISHER_TOL = {"vit": 1e-4, "rn": 1e-3}


def research_image(seed: int, split: int, c: int, i: int) -> np.ndarray:
    """A 96-px tissue-like patch: a class colour, smooth texture and noise."""
    rng = np.random.default_rng([seed, split, c, i])
    y, x = np.mgrid[0:RESEARCH_PX, 0:RESEARCH_PX].astype(np.float32)
    f, p = rng.uniform(0.05, 0.3, 2), rng.uniform(0, 6, 3)
    base = np.stack([(90, 170)[c] + (40, -30, 20)[ch] * (c - 0.5) + 30 * np.sin(x * f[0] + p[ch])
                     * np.cos(y * f[1] + p[ch]) for ch in range(3)], axis=-1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def write_research_corpus(root: str, seed: int) -> str:
    """The tree under ``root/patchcamelyon`` and the guidance TSV's path."""
    from flyp_tpu_torch.data.classnames import patchcamelyon_classnames

    rows = ["title\tfilepath\tlabel\tguidance\timg_id"]
    for s, (split, n) in enumerate(RESEARCH_SPLITS.items()):
        for c in range(2):
            d = os.path.join(root, "patchcamelyon", split, f"class_{c}")
            os.makedirs(d)
            for i in range(n):
                path = os.path.join(d, f"{i:03d}.png")
                with open(path, "wb") as f:
                    f.write(png_bytes(research_image(seed, s, c, i)))
                if split == "train":
                    for g in RESEARCH_GUIDANCE:
                        rows.append(f"this is a photo of {patchcamelyon_classnames[c]}\t{path}\t{c}\t{g}\t"
                                    f"{c * 1000 + i}")
    tsv = os.path.join(root, "guidance.tsv")
    with open(tsv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return tsv


def research_argv(root: str, tsv: str, name: str, *extra) -> list:
    return ["--model", MODEL, "--ft_data", tsv, "--ft_data_test", tsv, "--template", "patchcamelyon_template",
            "--train-dataset", "PatchCamelyonTrain", "--eval-datasets", "PatchCamelyonVal,PatchCamelyonTest",
            "--data-location", root, "--batch-size", str(RESEARCH_BATCH), "--workers", str(INPUT_WORKERS),
            "--seed", "0", "--lr", "1e-5", "--warmup_length", "1", "--exp_name", name, *extra]


def research_few_shot(root: str, tsv: str) -> dict:
    """(a) ``cli/few_shot.py``: one k = 16 run of 4 epochs at full depth;
    the kept snapshot's scores reproduce on the card (the trainer's own
    asserts), launches exact."""
    from flyp_tpu_torch.cli import few_shot as cli_few_shot
    from flyp_tpu_torch.cli import main as cli_main

    _, layers_v, layers_t = model_shape()
    n_test = 2 * RESEARCH_SPLITS["test"]
    argv = research_argv(root, tsv, "few_shot", "--k", str(FEW_SHOT_K), "--epochs", str(FEW_SHOT_EPOCHS), "--save",
                         os.path.join(root, "fs"))
    cwd = os.getcwd()
    os.chdir(root)  # cli/few_shot.py writes expt_logs/ under the working directory
    try:
        reset_counts()
        # ---- the few-shot path: counts start at 0 here -----------------------
        summary = cli_few_shot.main(cli_main.parse_main_arguments(argv), num_runs=1)
        torch.cuda.synchronize()
        got = counts()
        # ---- end of the few-shot path -----------------------------------------
    finally:
        os.chdir(cwd)
    # A step a epoch (both towers, B1 and B2 once a block); a head (the one
    # prompt a class: one chunk of the text tower) and the 2k-image
    # validation batch before training, after each epoch and for the
    # re-score; the test set through the re-scored head.
    scorings = FEW_SHOT_EPOCHS + 2
    want = dict(B1=FEW_SHOT_EPOCHS * (layers_v + layers_t), B2=FEW_SHOT_EPOCHS * (layers_v + layers_t),
                B3=scorings * (layers_t + layers_v) + layers_v * math.ceil(n_test / RESEARCH_BATCH))
    expect_counts("few-shot", **want)
    log(f"research: few-shot k={FEW_SHOT_K}, {FEW_SHOT_EPOCHS} epochs: {summary}; the kept snapshot re-scored "
        f"equal; launches {got}, as counted")
    return {"summary": summary, "launches": got}


def ce_step_check(images, labels, texts) -> dict:
    """The CE ablation's first step at B=4, full width: loss and gradients
    on the card (B3 forward, B1 + B2 backward) against the CPU plain step,
    fp32 at cosine 0.9999 and bf16 at 0.99 (phase 5's rule)."""
    from flyp_tpu_torch.training.ce_ablation import ce_loss

    def loss_grads(model, dev):
        model.requires_grad_(True)
        loss = ce_loss(model, torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev),
                       torch.from_numpy(texts).to(dev))
        return loss.item(), [g.float().cpu() for g in torch.autograd.grad(loss, list(model.parameters()))]

    cfg = {n: SimpleNamespace(model=MODEL, clip_load=None, compute_dtype=n, seed=0) for n in ("float32", "bfloat16")}
    ref_loss, ref_grads = loss_grads(build_clip_model(cfg["float32"], device="cpu"), "cpu")
    out = {}
    for name, min_cos, loss_tol in (("float32", 0.9999, 1e-4), ("bfloat16", 0.99, 2e-2)):
        model = build_clip_model(cfg[name], device="cuda")
        _, layers_v, layers_t = model_shape()
        reset_counts()
        loss, grads = loss_grads(model, "cuda")
        expect_counts(f"CE step ({name})", B3=layers_v + layers_t, B1=layers_v + layers_t, B2=layers_v + layers_t)
        cos = grad_cosines(grads, ref_grads)
        rel = abs(loss - ref_loss) / abs(ref_loss)
        log(f"research: CE step, {name}, B=4: loss {loss:.7f} against the CPU's {ref_loss:.7f} (rel err {rel:.3g}), "
            f"min grad cosine {min(cos):.7f}")
        if rel > loss_tol or min(cos) < min_cos:
            names = [n for n, _ in model.named_parameters()]
            raise AssertionError(f"CE step ({name}) drifts from the CPU plain step: loss rel err {rel}, worst "
                                 f"{sorted(zip(cos, names))[:5]}")
        out[name] = {"loss_rel_err": rel, "min_grad_cosine": min(cos)}
        del model, grads
    return out


def ce_step_ms() -> tuple:
    """ms of one CE ablation step at batch 32 (bf16, AdamW), full width,
    and a profile of one more (device busy share, the port's kernels'
    share, the top kernels)."""
    from flyp_tpu_torch.data.classnames import patchcamelyon_classnames
    from flyp_tpu_torch.templates import get_template
    from flyp_tpu_torch.tokenizer import tokenize
    from flyp_tpu_torch.training.ce_ablation import make_ce_train_step

    model = build_clip_model(SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="bfloat16", seed=0),
                             device="cuda")
    opt = make_optimizer(warmup_cosine_lr(1e-5, 1, 100), 0.1)
    state = create_train_state(model, opt)
    step = make_ce_train_step(model, opt)
    px = model.config.vision.image_size
    images = torch.randn(RESEARCH_BATCH, px, px, 3, device="cuda", dtype=torch.bfloat16)
    labels = torch.arange(RESEARCH_BATCH, device="cuda") % 2
    template = get_template("patchcamelyon_template")
    texts = torch.from_numpy(shrink_context(tokenize([template[0](c) for c in patchcamelyon_classnames]))).cuda()
    ms = cuda_ms(lambda: step(state, images, labels, texts), iters=10, warmup=3)
    return ms, device_profile(lambda: step(state, images, labels, texts), {"port": PORT_KERNELS})


def ce_gloo_rank(rank: int, world: int, port: int, argv: list, cwd: str):
    """One rank of the CE ablation on gloo, both ranks on card 0, at
    ``TRAINER_DEPTH``."""
    import datetime

    import torch.distributed as dist

    from flyp_tpu_torch.cli import main as cli_main

    os.chdir(cwd)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        use_impl("auto")
        with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
            cli_main.main(cli_main.parse_main_arguments(argv))
    finally:
        dist.destroy_process_group()


def ce_losses(cwd: str, name: str) -> list:
    base = os.path.join(cwd, "expt_logs", name)
    (key,) = os.listdir(base)
    with open(os.path.join(base, key, "metrics.jsonl")) as f:
        return [r["ID CE Loss"] for r in map(json.loads, f) if "ID CE Loss" in r]


def research_ce(root: str, tsv: str) -> dict:
    """(b) the CE ablation: its first step against the CPU, then
    ``cli/main.py --ce_ablation`` for one epoch with exact launches, then 2
    gloo ranks at ``TRAINER_DEPTH`` against one process."""
    import torch.multiprocessing as mp

    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.data.classnames import patchcamelyon_classnames
    from flyp_tpu_torch.templates import get_template
    from flyp_tpu_torch.tokenizer import tokenize

    px, layers_v, layers_t = model_shape()
    images, _ = bench_batch(4, px, seed=0)
    labels = np.array([0, 1, 1, 0], np.int64)
    template = get_template("patchcamelyon_template")
    texts = shrink_context(tokenize([template[0](c) for c in patchcamelyon_classnames]))
    out = {"step": ce_step_check(images, labels, texts)}
    out["step_ms_bf16_b32"], out["step_profile"] = ce_step_ms()
    log(f"research: CE step at batch {RESEARCH_BATCH}, bf16: {out['step_ms_bf16_b32']:.3f} ms, device busy "
        f"{out['step_profile'].get('busy_share', float('nan')):.3f} of one profiled step")

    cwd = os.getcwd()
    os.chdir(root)  # cli/main.py writes expt_logs/ under the working directory
    try:
        n_train = 2 * RESEARCH_SPLITS["train"]
        steps = n_train // RESEARCH_BATCH
        n_eval = 2 * RESEARCH_SPLITS["val"] + 2 * RESEARCH_SPLITS["test"]
        argv = research_argv(root, tsv, "ce", "--ce_ablation", "--epochs", "1", "--save", os.path.join(root, "ce"))
        reset_counts()
        # ---- the CE ablation path: counts start at 0 here --------------------
        ret = cli_main.main(cli_main.parse_main_arguments(argv))
        torch.cuda.synchronize()
        out["launches"] = counts()
        # ---- end of the CE ablation path --------------------------------------
        per_step = layers_v + layers_t
        evals = math.ceil(2 * RESEARCH_SPLITS["val"] / RESEARCH_BATCH) + math.ceil(
            2 * RESEARCH_SPLITS["test"] / RESEARCH_BATCH)
        expect_counts("the CE ablation", B1=steps * per_step, B2=steps * per_step,
                      B3=steps * per_step + layers_t + layers_v * evals)
        losses = ce_losses(root, "ce")
        if os.path.basename(ret) != "checkpoint_0" or len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"the CE ablation returned {ret}, logged losses {losses}")
        log(f"research: cli/main.py --ce_ablation, one epoch of {steps} steps and {n_eval} evaluation images: losses "
            f"{losses}; launches {out['launches']}, as counted")
        out["losses"] = losses

        # Across ranks, at the trainer depth: one process, then 2 gloo ranks.
        extra = ("--ce_ablation", "--epochs", "1", "--warmup_length", "0", "--compute_dtype", CE_RANK_DTYPE)
        with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
            t0 = time.perf_counter()
            cli_main.main(cli_main.parse_main_arguments(research_argv(root, tsv, "ce_single", *extra)))
            out["single_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mp.start_processes(ce_gloo_rank, args=(2, _free_port(), research_argv(root, tsv, "ce_ranks", *extra), root),
                           nprocs=2, join=True, start_method="spawn")
        out["ranks_s"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    single, ranks = ce_losses(root, "ce_single"), ce_losses(root, "ce_ranks")
    rel = _rel(ranks, single)
    out.update(single_losses=single, rank_losses=ranks, rank_loss_rel_err=rel)
    log(f"research: the CE ablation on 2 gloo ranks: losses {ranks} against one process's {single} (rel err "
        f"{max(rel):.3g}, bound {PARALLEL_LOSS_TOL}; the first step's {rel[0]:.3g}, bound 1e-6)")
    if len(ranks) != len(single) or not single or max(rel) > PARALLEL_LOSS_TOL or rel[0] > 1e-6:
        raise AssertionError(f"the CE ablation on 2 ranks drifts from one process: {ranks} vs {single}")
    return out


def fisher_rel_errs(got: dict, ref: dict) -> dict:
    """Per tensor ||a - b|| / ||b|| over the tensors with a nonzero Fisher,
    those whose exact gradient is zero (``ZERO_GRADS``) left out."""
    return {k: float((got[k].double() - v.double()).norm() / v.double().norm()) for k, v in ref.items()
            if float(v.norm()) > 0 and k not in ZERO_GRADS}


def check_zero_fishers(fishers, where: str) -> None:
    """A tensor whose exact gradient is zero has a Fisher of rounding size:
    below 1e-8 of the largest (the square of grad_report's 1e-5 on
    gradients, with room)."""
    for f in fishers:
        largest = max(float(v.norm()) for v in f.values())
        for k in ZERO_GRADS:
            if k in f and float(f[k].norm()) > 1e-8 * largest:
                raise AssertionError(f"{where}: {k}'s Fisher is not ~0: {float(f[k].norm())} of {largest}")


def summed_gradient_squared(model, head, images, labels) -> dict:
    """The planted fault: the square of the batch-summed gradient (one
    batch forward and backward) in place of the sum of per-example squares."""
    from flyp_tpu_torch.training import fisher

    with fisher._fisher_mode(model, grad=True):
        logits = head(model.encode_image(images)).float()
        loss = torch.nn.functional.cross_entropy(logits, labels, reduction="sum")
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g.float().square()).cpu()
            for (n, p), g in zip(model.named_parameters(), grads)}


def research_fisher() -> dict:
    """(c) the Fisher step, fp32: 16 ViT-B/16 images at full depth and 8
    RN50 images at ``RN_TRAINER_DEPTH`` on the card (labels drawn there)
    against the CPU port on the same images and labels; the planted fault
    must fail the bound; ms per example (also ViT-B/16 in bf16)."""
    from flyp_tpu_torch.data.classnames import patchcamelyon_classnames
    from flyp_tpu_torch.templates import get_template
    from flyp_tpu_torch.training.fisher import make_fisher_step

    out = {}
    template = get_template("patchcamelyon_template")
    cases = (("vit", MODEL, {}, FISHER_VIT_IMAGES), ("rn", RN_MODEL, RN_TRAINER_DEPTH, FISHER_RN_IMAGES))
    for tower, name, depth, n in cases:
        with cut_depth(name, **depth):
            spec = SimpleNamespace(model=name, clip_load=None, compute_dtype="float32", seed=0)
            model = build_clip_model(spec, device="cuda")
            px = model.config.vision.image_size
            layers_v = model.config.vision.layers if tower == "vit" else 0
            images = torch.from_numpy(bench_batch(n, px, seed=1)[0])
            head = get_zeroshot_classifier(model, patchcamelyon_classnames, template)
            step = make_fisher_step(model, head, seed=0)
            torch.cuda.synchronize()
            drawn, real = [], torch.multinomial
            torch.multinomial = lambda *a, **k: drawn.append(real(*a, **k)) or drawn[-1]
            reset_counts()
            # ---- the Fisher step: counts start at 0 here -----------------------
            try:
                t0 = time.perf_counter()
                sq, _ = step(images.cuda())
                torch.cuda.synchronize()
                card_s = time.perf_counter() - t0
            finally:
                torch.multinomial = real
            got = counts()
            # ---- end of the Fisher step -----------------------------------------
            # ViT: one batch forward for the labels, then B3 forward and B1 + B2
            # backward a block for each example; the RN tower runs no kernel.
            expect_counts(f"Fisher ({name})", B3=layers_v * (1 + n), B1=layers_v * n, B2=layers_v * n)
            labels = drawn[0][:, 0]
            sq = {k: v.cpu() for k, v in sq.items()}
            cpu = build_clip_model(spec, device="cpu")
            cpu_head = copy.deepcopy(head).to("cpu")  # the same head on both sides
            t0 = time.perf_counter()
            ref, _ = make_fisher_step(cpu, cpu_head)(images, labels.cpu())
            cpu_s = time.perf_counter() - t0
            bound, spread = FISHER_TOL[tower], None
            if tower == "rn":
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    ref1, _ = make_fisher_step(cpu, cpu_head)(images, labels.cpu())
                finally:
                    torch.set_num_threads(threads)
                check_zero_fishers([ref1], f"Fisher {name} on the CPU")
                spread = max(fisher_rel_errs(ref1, ref).values())
                bound = max(bound, SPREAD_FACTOR * spread)
            check_zero_fishers([sq, ref], f"Fisher {name}")
            errs = fisher_rel_errs(sq, ref)
            fault = fisher_rel_errs(summed_gradient_squared(model, head, images.cuda(), labels), ref)
            worst, fault_worst = max(errs.values()), max(fault.values())
            rec = {"images": n, "ms_per_example_fp32": 1e3 * card_s / n, "cpu_ms_per_example": 1e3 * cpu_s / n,
                   "max_rel_err": worst, "median_rel_err": float(np.median(list(errs.values()))),
                   "cpu_spread": spread, "fault_max_rel_err": fault_worst, "bound": bound, "launches": got}
            log(f"research: Fisher {name} ({n} images, fp32): {rec['ms_per_example_fp32']:.2f} ms an example on the "
                f"card ({rec['cpu_ms_per_example']:.1f} on the CPU); per-tensor rel err against the CPU max "
                f"{worst:.3g}, median {rec['median_rel_err']:.3g} (bound {bound:.3g}; the CPU's own spread "
                f"{spread}); the planted fault {fault_worst:.3g}")
            if worst > bound:
                raise AssertionError(f"the Fisher of {name} on the card drifts from the CPU's: {worst} > {bound}")
            if fault_worst <= bound:
                raise AssertionError(f"the planted Fisher fault passes the {name} bound: {fault_worst} <= {bound}")
            del model, cpu
            if tower == "vit":
                bf16 = build_clip_model(SimpleNamespace(model=name, clip_load=None, compute_dtype="bfloat16",
                                                        seed=0), device="cuda")
                step16 = make_fisher_step(bf16, head, seed=0)
                step16(images.cuda())  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step16(images.cuda())
                torch.cuda.synchronize()
                rec["ms_per_example_bf16"] = 1e3 * (time.perf_counter() - t0) / n
                log(f"research: Fisher {name} in bf16: {rec['ms_per_example_bf16']:.2f} ms an example")
                del bf16
            out[tower] = rec
    return out


def research_probe(root: str, tsv: str) -> dict:
    """(d) ``training/linear_probe.py``: the image features through B3
    (launches exact), the C sweep on the card in the features' float32,
    and the same sweep on the CPU in float64: the same best i, C and
    accuracy."""
    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.training.linear_probe import linear_probe, log_reg_warm_start_sweep
    from flyp_tpu_torch.utils.logging import get_logger

    _, layers_v, _ = model_shape()
    cache = os.path.join(root, "probe_cache")
    cfg = cli_main.parse_main_arguments(research_argv(root, tsv, "probe", "--eval-datasets", "PatchCamelyonVal",
                                                      "--cache-dir", cache))
    model = build_clip_model(cfg, device="cuda")
    reset_counts()
    # ---- the linear probe: counts start at 0 here ------------------------------
    t0 = time.perf_counter()
    best = linear_probe(cfg, get_logger(None), model=model, num_cs=PROBE_CS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    # ---- end of the linear probe -------------------------------------------------
    batches = sum(math.ceil(2 * RESEARCH_SPLITS[s] / RESEARCH_BATCH) for s in ("train", "val"))
    expect_counts("the linear probe's features", B3=layers_v * batches)
    feats = {}
    for split, ds in (("train", "PatchCamelyonTrain"), ("val", "PatchCamelyonVal")):
        with np.load(os.path.join(cache, ds, split, "features.npz")) as z:
            feats[split] = (z["features"].astype(np.float64), z["labels"])
    t0 = time.perf_counter()
    ref = log_reg_warm_start_sweep(*feats["train"], *feats["val"], num_cs=PROBE_CS, device="cpu")
    cpu_s = time.perf_counter() - t0
    got = (best["i"], best["c"], best["acc"])
    log(f"research: linear probe over {PROBE_CS} C: best (i, C, acc) {got} on the card in float32 ({card_s:.1f} s with "
        f"the features), {(ref['i'], ref['c'], ref['acc'])} on the CPU in float64 ({cpu_s:.1f} s)")
    if got != (ref["i"], ref["c"], ref["acc"]):
        raise AssertionError(f"the probe's best fit on the card {got} differs from the CPU's float64 one")
    return {"best": {"i": best["i"], "c": best["c"], "acc": best["acc"]}, "card_s": card_s, "cpu_float64_s": cpu_s,
            "coef_rel_err": float(np.linalg.norm(best["coef"] - ref["coef"]) / np.linalg.norm(ref["coef"]))}


def state_digest(model) -> str:
    """A hash of every parameter's and buffer's bits."""
    return digest([t.reshape(-1) for t in model.state_dict().values()])


def research_beam(root: str, tsv: str) -> dict:
    """(e) ``training/progress.py`` at ``TRAINER_DEPTH``: beam 2, one
    round; each kept snapshot, restored, holds the trained candidate's
    state bit for bit and gives its ``progress_eval`` again."""
    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.training import progress
    from flyp_tpu_torch.utils.logging import get_logger

    cfg = cli_main.parse_main_arguments(research_argv(root, tsv, "beam", "--curriculum", "--eval-datasets",
                                                      "PatchCamelyonVal", "--save", os.path.join(root, "beam")))
    cfg.log_dir = os.path.join(root, "beam_logs")
    seen = []
    real = progress.progress_eval

    def recorded(cfg, model, *args, **kwargs):
        res = real(cfg, model, *args, **kwargs)
        seen.append((state_digest(model), res[2]))
        return res

    with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
        model = build_clip_model(cfg, device="cuda")
        progress.progress_eval = recorded
        try:
            beam = progress.flyp_progress_validation(cfg, get_logger(None), model=model, beam_size=2, num_rounds=1,
                                                     select_metric="Avg OOD Acc")
        finally:
            progress.progress_eval = real
        trained = seen[1:]  # after the starting point's: one a guidance
        state = progress.create_train_state(model, progress.make_optimizer(lambda c: 0.0, 0.0))
        restored = []
        for path in beam:
            state, last_perform, step = progress._restore(path, state)
            stats = real(cfg, model, {}, 0, get_logger(None))[2]
            restored.append((state_digest(model), stats))
            if restored[-1] not in trained or stats != last_perform:
                raise AssertionError(f"the snapshot {path} does not restore its candidate: {restored[-1]} not in "
                                     f"{trained}")
    names = sorted(os.listdir(cfg.log_dir))
    if len(beam) != 2 or sum(n.startswith("progress0_") for n in names) != 3:
        raise AssertionError(f"the beam search kept {beam} and wrote {names}")
    log(f"research: beam search (beam 2, one round) kept {[os.path.basename(p) for p in beam]}; each restored "
        f"snapshot holds its candidate's state bit for bit and gives its progress_eval {[s for _, s in restored]}")
    return {"beam": [os.path.basename(p) for p in beam], "tsvs": names, "step": step}


def phase_research(card: str, seed: int = 0) -> dict:
    """Phase 13: the research trainers, (a)-(e), each timed."""
    t_phase = time.perf_counter()
    out = {"card": card, "s": {}}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        tsv = write_research_corpus(root, seed)
        out["s"]["corpus"] = time.perf_counter() - t0
        for part, fn in (("few_shot", lambda: research_few_shot(root, tsv)), ("ce", lambda: research_ce(root, tsv)),
                         ("fisher", research_fisher), ("probe", lambda: research_probe(root, tsv)),
                         ("beam", lambda: research_beam(root, tsv))):
            t0 = time.perf_counter()
            out[part] = fn()
            out["s"][part] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"research: seconds {out['s']}; phase took {out['phase_s']:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: HTTP serving, entry(), the dry run and the tools.

SURFACE_SIZES = (5, 64)  # images a request
SURFACE_REPS = 5  # timed requests of each kind, after the counted round
SURFACE_THREADS, SURFACE_CONCURRENT = 4, 8
SURFACE_PER_CLASS = 1  # ImageNet's reader takes its 1,000 classes; one image each
NPY = "application/x-npy"


def http_json(port: int, path: str, body=None, ctype="application/json"):
    """A request to the bound server; anything but 200 raises."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={} if body is None else {"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def npy_bytes(a: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def response_arrays(kind: str, out: dict) -> tuple:
    """A JSON answer as the direct call returns it (float32 arrays)."""
    if kind.startswith("classify"):
        idx = np.asarray(out["indices"])
        if out["classes"] != [[CLASSNAMES[j] for j in row] for row in idx]:
            raise AssertionError(f"HTTP {kind}: classes {out['classes']} do not name indices {idx.tolist()}")
        return np.asarray(out["probs"], np.float32), idx
    return (np.asarray(out["features"], np.float32),)


def median_ms(fn, reps: int = SURFACE_REPS) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def surface_http(srv, card: str) -> dict:
    """Phase 14 (a): ``serve_http`` over ``srv`` on an ephemeral port; every
    answer bit-equal to the direct call (float32 through ``tolist()`` and
    JSON is exact), B3's launches exact on a sequential round and on 8
    requests from 4 threads (``pinned_mode``'s lock serialises the
    forwards, so the counters stay exact), ms a request beside the direct
    call (each returns host arrays, so the host clock holds the device
    work)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from flyp_tpu_torch.serving import serve_http

    t_phase = time.perf_counter()
    cfg = srv.model.config
    px, layers_v, layers_t = cfg.vision.image_size, cfg.vision.layers, cfg.text.layers
    rng = np.random.default_rng(14)
    imgs = {n: rng.standard_normal((n, px, px, 3)).astype(np.float32) for n in SURFACE_SIZES}
    texts = [f"a photo of a {c}." for c in CLASSNAMES] * 2
    # kind -> (path, body, content type, the direct call, its B3 launches)
    requests = {}
    for n in SURFACE_SIZES:
        body = npy_bytes(imgs[n])
        requests[f"features_{n}"] = ("/features", body, NPY, lambda n=n: (srv.encode_images(imgs[n]),),
                                     layers_v * chunks(n))
        requests[f"classify_{n}"] = ("/classify?k=3", body, NPY, lambda n=n: srv.top_k(imgs[n], k=3),
                                     layers_v * chunks(n))
    requests["text_features"] = ("/text_features", json.dumps({"texts": texts}).encode(), "application/json",
                                 lambda: (srv.encode_texts(texts),), layers_t * chunks(len(texts)))

    def check(kind, out, where):
        for got, want in zip(response_arrays(kind, out), direct[kind]):
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{where} {kind}: the answer differs from the direct call "
                                     f"(max abs {np.abs(got.astype(np.float64) - want).max()})")

    httpd = serve_http(srv, 0, classnames=CLASSNAMES)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    out = {}
    try:
        health = http_json(port, "/healthz")
        want_health = {"ok": True, "model": "CLIPModel", "buckets": list(BUCKETS), "num_classes": len(CLASSNAMES)}
        if health != want_health:
            raise AssertionError(f"HTTP /healthz: {health}, expected {want_health}")
        direct = {kind: r[3]() for kind, r in requests.items()}  # the reference, before the counted round
        reset_counts()
        # ---- the HTTP path: counts start at 0 here ----------------------------
        answers = {kind: http_json(port, *r[:3]) for kind, r in requests.items()}
        launches = counts()
        # ---- end of the HTTP path ---------------------------------------------
        expect_counts("HTTP requests", B3=sum(r[4] for r in requests.values()))
        for kind, answer in answers.items():
            check(kind, answer, "HTTP")
        order = [list(requests)[i % len(requests)] for i in range(SURFACE_CONCURRENT)]
        reset_counts()
        with ThreadPoolExecutor(max_workers=SURFACE_THREADS) as pool:
            concurrent = list(pool.map(lambda kind: http_json(port, *requests[kind][:3]), order, timeout=600))
        expect_counts("concurrent HTTP requests", B3=sum(requests[kind][4] for kind in order))
        for kind, answer in zip(order, concurrent):
            check(kind, answer, f"{SURFACE_THREADS} threads:")
        out["ms"] = {kind: {"http_ms": median_ms(lambda r=r: http_json(port, *r[:3])),
                            "direct_ms": median_ms(r[3])} for kind, r in requests.items()}
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    out.update(launches=launches["B3"], concurrent=len(order), threads=SURFACE_THREADS,
               s=time.perf_counter() - t_phase)
    log(f"HTTP: {len(requests) + 1} requests bit-equal to the direct calls with {launches['B3']} B3 launches, "
        f"{len(order)} more on {SURFACE_THREADS} threads; ms a request (HTTP, direct) "
        f"{ {k: (round(v['http_ms'], 2), round(v['direct_ms'], 2)) for k, v in out['ms'].items()} } on {card}; "
        f"{out['s']:.1f} s")
    return out


def surface_entry(card: str) -> dict:
    """Phase 14 (b): ``entry()`` on the card, its launches exact; its loss
    finite and within bf16 rounding of the plain route's on the same model
    and batch, and what it computes, the image and text features, at least
    0.99 row cosine to the plain route's (near-orthogonal features of a
    broken forward give a loss near ln 8 too, so the loss alone does not
    hold B3)."""
    from flyp_tpu_torch.entry import entry
    from flyp_tpu_torch.models.modes import pinned_mode

    t0 = time.perf_counter()
    fn, args = entry()
    model = args[0]
    blocks = model.config.vision.layers + model.config.text.layers
    build_s = time.perf_counter() - t0
    reset_counts()
    # ---- entry(): counts start at 0 here ----------------------------------
    loss = fn(*args)
    torch.cuda.synchronize()
    launches = counts()
    # ---- end of entry() ---------------------------------------------------
    expect_counts("entry()", B3=blocks)
    loss = float(loss)

    def features():
        with torch.inference_mode(), pinned_mode(model, train=False):
            img_f, txt_f, _ = model(*args[1:])
        return img_f.float().cpu().numpy(), txt_f.float().cpu().numpy()

    fused = features()
    use_impl("xla")
    try:
        plain = float(fn(*args))
        plain_f = features()
    finally:
        use_impl("auto")
    cos = {tower: float(cosine(a, b).min()) for tower, a, b in zip(("image", "text"), fused, plain_f)}
    if not math.isfinite(loss) or abs(loss - plain) > TOL[torch.bfloat16] * max(1.0, abs(plain)) \
            or min(cos.values()) < 0.99:
        raise AssertionError(f"entry(): loss {loss} against the plain route's {plain}, least feature cosine {cos}")
    ms = cuda_ms(lambda: fn(*args), iters=10, warmup=2)
    out = {"loss": loss, "plain_loss": plain, "min_cosine": cos, "launches": launches["B3"], "ms": ms,
           "build_s": build_s, "s": time.perf_counter() - t0}
    log(f"entry(): loss {loss:.5f} (plain route {plain:.5f}), least feature cosine to the plain route {cos}, "
        f"{launches['B3']} B3 launches, {ms:.2f} ms a call on {card}; {out['s']:.1f} s")
    del fn, args, model
    torch.cuda.empty_cache()
    return out


def surface_dryrun(card: str) -> dict:
    """Phase 14 (c): ``dryrun_multichip(DRYRUN_RANKS)`` on the card; its step
    on the fused block route launched B1 and B2 once a block of the tiny
    model on rank 0."""
    from flyp_tpu_torch.entry import DRYRUN_RANKS, _tiny_config, dryrun_multichip

    cfg = _tiny_config(real_text=True)
    blocks = cfg.vision.layers + cfg.text.layers
    out = dryrun_multichip(DRYRUN_RANKS)
    if out["pallas_block_launches"] != {"B1": blocks, "B2": blocks}:
        raise AssertionError(f"dry run: step 7 launched {out['pallas_block_launches']}, expected B1 = B2 = {blocks}")
    log(f"dry run: {out['backend']} ranks (shared card: {out['shared_card']}), seconds {out['seconds']}, "
        f"{out['seconds_total']:.1f} s in all on {card}")
    return out


def surface_tools(card: str, root: str, seed: int = 14) -> dict:
    """Phase 14 (d): the offline tools on trees written here."""
    import csv
    import io

    from flyp_tpu_torch.templates import get_template
    from flyp_tpu_torch.tools import validate_checkpoint, validate_data
    from flyp_tpu_torch.tools.datacreation import fmow_csv, folder_csv, iwildcam_csv, train_test_split

    t_phase = time.perf_counter()
    out = {"s": {}}
    px, layers_v, layers_t = model_shape()
    jobs, expected = imagenet_val_jobs(root, per_class=SURFACE_PER_CLASS)
    small = [(os.path.join(root, "small", c, f"{i}.png"), False) for c in ("ant", "bee_fly") for i in range(10)]
    write_pngs(jobs + small, seed)
    n_val = len(expected["ImageNet"]["labels"])

    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        rc = validate_data.main(["--dataset", "ImageNet", "--root", root, "--batch_size", str(EVAL_BATCH),
                                 "--probe", "4", "--workers", str(EVAL_WORKERS)])
    report = report.getvalue()
    if rc != 0 or "OK ImageNet" not in report or f"test samples:    {n_val} " not in report \
            or "classes:         1000" not in report:
        raise AssertionError(f"validate_data: rc {rc}, report {report!r}")
    out["s"]["validate_data"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu_model = build_clip_model(SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="float32", seed=0),
                                 device="cpu")
    ckpt = os.path.join(root, "vit_b16_random.pt")
    convert.save_torch_checkpoint(ckpt, convert.export_clip_state_dict(cpu_model.state_dict(), cpu_model.config))
    del cpu_model
    out["s"]["pt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prompts = 1000 * len(get_template("simple_template"))
    want_b3 = layers_t * math.ceil(prompts / min(1024, max(8, prompts))) + layers_v * math.ceil(n_val / EVAL_BATCH)
    printed = io.StringIO()
    with contextlib.chdir(root), contextlib.redirect_stdout(printed):  # the evaluation's log goes under root
        reset_counts()
        # ---- validate_checkpoint: counts start at 0 here --------------------
        stats = validate_checkpoint.main(["--checkpoint", ckpt, "--model", MODEL, "--train-dataset", "ImageNet",
                                          "--template", "simple_template", "--eval-datasets", "ImageNet",
                                          "--data-location", root, "--batch-size", str(EVAL_BATCH),
                                          "--workers", str(EVAL_WORKERS)])
        launches = counts()
        # ---- end of validate_checkpoint -------------------------------------
    expect_counts("validate_checkpoint", B3=want_b3)
    top1 = stats.get("ImageNet Accuracy")
    if top1 is None or not 0.0 <= top1 <= 1.0 or str(stats) not in printed.getvalue():
        raise AssertionError(f"validate_checkpoint: stats {stats}")
    out.update(validate_checkpoint={"launches": launches["B3"], "top1": top1, "stats": len(stats)})
    out["s"]["validate_checkpoint"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ref_root = os.path.join(root, "reference")
    os.makedirs(os.path.join(ref_root, "clip"))
    with open(os.path.join(ref_root, "clip", "model.py"), "w") as f:
        f.write(reference_stand_in())
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        reset_counts()
        # ---- activation_crosscheck: counts start at 0 here ------------------
        diff = validate_checkpoint.activation_crosscheck(ckpt, ref_root, "cuda")
        cross = counts()
        # ---- end of activation_crosscheck -----------------------------------
    if cross["B3"] != layers_v + layers_t:
        raise AssertionError(f"activation_crosscheck: {cross['B3']} B3 launches, expected {layers_v + layers_t}")
    blocks = {name: float(d) for name, d in re.findall(r"^\s+(\S+): max abs diff (\S+)$", printed.getvalue(), re.M)}
    scale = max(float(np.abs(a).max()) for a in sys.modules["ref_clip_model"].FEATURES)
    if len(blocks) != layers_v + layers_t + 2 or not all(map(math.isfinite, blocks.values())) \
            or diff > 1e-3 * scale:
        raise AssertionError(f"activation_crosscheck: features diff {diff} (largest entry {scale}), blocks {blocks}")
    out["crosscheck"] = {"launches": cross["B3"], "max_abs_diff": diff, "feature_scale": scale,
                         "max_block_diff": max(blocks.values())}
    out["s"]["crosscheck"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = {}
    tsv = os.path.join(root, "csv")
    n = folder_csv.build_csv(os.path.join(root, "small"), os.path.join(tsv, "folder.tsv"), "simple_template")
    rows["folder_csv"] = n
    with open(os.path.join(tsv, "folder.tsv")) as f:
        lines = f.read().splitlines()
    if n != 20 or len(lines) != 21 or lines[0] != "title\tfilepath\tlabel" or lines[-1].split("\t")[0] != \
            "a photo of a bee fly.":
        raise AssertionError(f"folder_csv: {n} rows, {lines[:2]} ... {lines[-1:]}")
    split = train_test_split.split_folder(os.path.join(root, "small"), os.path.join(root, "split"), seed=seed)
    if sum(split.values()) != 20 or sorted(split) != ["test", "train", "val"]:
        raise AssertionError(f"train_test_split: {split}")
    rows["train_test_split"] = split
    fmow = os.path.join(root, "fmow_v1.1")
    os.makedirs(fmow)
    with open(os.path.join(fmow, "rgb_metadata.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["split", "timestamp", "category"])
        w.writerows([("train", "2010-03-01T12:00:00Z", "airport"), ("train", "2014-06-01T12:00:00Z", "airport"),
                     ("seq", "2010-01-01T00:00:00Z", "barn"), ("train", "2012-12-31 23:59:59", "barn")])
    rows["fmow_csv"] = fmow_csv.build_csv(fmow, os.path.join(tsv, "fmow.tsv"))
    if rows["fmow_csv"] != 2 * len(get_template("fmow_template")):
        raise AssertionError(f"fmow_csv: {rows['fmow_csv']} rows")
    labels = os.path.join(root, "iwildcam_labels.csv")
    with open(labels, "w") as f:
        f.write("name,english,y\nant,ant,3\nbee fly,bee fly,7\nempty,empty,99999\n")
    crops = os.path.join(root, "crops")
    for c in ("ant", "bee_fly"):
        os.makedirs(os.path.join(crops, c, "Strength30_aug"))
        for i in range(3):
            for d in (os.path.join(crops, c), os.path.join(crops, c, "Strength30_aug")):
                open(os.path.join(d, f"{c}{i}.jpg"), "wb").close()
    df = iwildcam_csv.collect_rows(crops, labels, strength_folders=True)
    rows["iwildcam_csv"] = iwildcam_csv.write_csv(df, labels, os.path.join(tsv, "iwildcam.tsv"))
    if rows["iwildcam_csv"] != 12 or sorted(set(df["guidance"])) != [70, 100]:
        raise AssertionError(f"iwildcam_csv: {rows['iwildcam_csv']} rows, guidance {sorted(set(df['guidance']))}")
    out["rows"] = rows
    out["s"]["datacreation"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tools: validate_data and validate_checkpoint ({launches['B3']} B3 launches, top-1 {top1}) on {n_val} "
        f"PNGs, activation_crosscheck on the card {out['crosscheck']}, datacreation rows {rows}; "
        f"seconds {out['s']} on {card}")
    return out


def phase_surface(card: str, http: dict) -> dict:
    """Phase 14 but its HTTP part (``http``, run over phase 4's server):
    ``entry()``, the dry run and the tools, with the seconds of each."""
    t0 = time.perf_counter()
    out = {"http": http, "entry": surface_entry(card), "dryrun": surface_dryrun(card)}
    with tempfile.TemporaryDirectory() as root:
        out["tools"] = surface_tools(card, root)
    out["phase_s"] = http["s"] + time.perf_counter() - t0
    log(f"surface: phase took {out['phase_s']:.1f} s on {card}")
    return out


# Phase 15: the measurement and check tools (flyp_tpu_torch/tools/), ViT-L/14
# trained and served at full width on the default route.
VIT_L = "ViT-L/14"
VIT_L_336 = "ViT-L/14@336px"
VIT_L_TRAIN = (256, 3)  # the recipe's batch (with --remat), timed steps after one warm-up
VIT_L_CHUNKED = (512, 8, 2)  # grad_cache_bench: global batch, chunks, timed steps after one warm-up
VIT_L_SERVE = ((8, 256), 10)  # serving_bench: batch sizes, iterations after one warm-up
VIT_L_336_SERVE = ((64,), 5)
BREAKDOWNS = {VIT_L: dict(iters=5, step_iters=2), "ViT-B/32": dict(iters=10, step_iters=3)}
RN_BREAKDOWN_ITERS = 10
CONVERGENCE_STEPS = 120
DRIFT = dict(steps=60, batch=64, pool=64)
SYNC_AB = dict(blocks=1, steps=5)
EVAL_AB = dict(blocks=1, steps=3)
HOST_DECODE = dict(n_images=16, px=224, iters=2)
E2E_ARGV = ["--epochs", "1", "--batch-size", "64", "--images-per-class", "32"]


def layers_of(name: str) -> tuple:
    c = MODEL_CONFIGS[name]
    return c.vision.layers, c.text.layers


def plain_cosine(fn, x) -> float:
    """Least row cosine of ``fn(x)`` on the default route against the plain
    route's, with B3 once a vision block of the default call."""
    with torch.inference_mode():
        got = fn(x).float().cpu().numpy()
        with plain_route():
            ref = fn(x).float().cpu().numpy()
    return float(cosine(got, ref).min())


def measure_vit_l_train(card: str) -> tuple:
    """ViT-L/14 at the recipe's batch 256 with --remat on the default route:
    one step's loss and gradients against the plain route on the card, the
    timed direct step (it must fit: any error raises), MFU, peak memory and
    a profiled step (B2's share).  Returns (results, the trained model)."""
    from flyp_tpu_torch.tools._bench import build_bench_step

    B, steps = VIT_L_TRAIN
    layers_v, layers_t = layers_of(VIT_L)
    per_step = layers_v + layers_t
    out = {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    step, state, images, tokens, _ = build_bench_step(B, VIT_L, remat=True)
    model = state.model
    out["build_s"] = time.perf_counter() - t0

    reset_counts()
    loss, grads = loss_and_grads(model, images, tokens)
    expect_counts("ViT-L/14 loss and gradients", B1=per_step, B2=per_step)
    with plain_route():
        ref_loss, ref_grads = loss_and_grads(model, images, tokens)
    expect_counts("ViT-L/14 loss and gradients, then the plain route", B1=per_step, B2=per_step)
    cos = grad_cosines(grads, ref_grads)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    del grads, ref_grads
    log(f"ViT-L/14 step at {B}, bf16, remat: loss {loss:.5f} against the plain route's {ref_loss:.5f} (rel err "
        f"{rel:.3g}), least gradient cosine {min(cos):.6f}")
    if rel > 2e-2 or min(cos) < 0.99:
        names = [n for n, _ in model.named_parameters()]
        raise AssertionError(f"ViT-L/14's step drifts from the plain route: loss rel err {rel}, worst "
                             f"{sorted(zip(cos, names))[:5]}")
    out.update(loss=loss, plain_loss=ref_loss, loss_rel_err=rel, min_grad_cosine=min(cos))

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # ---- the ViT-L/14 training path: counts start at 0 here ------------------
    state, metrics = step(state, images, tokens)
    first = float(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, images, tokens)
    last = float(metrics["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = counts()
    # ---- end of the ViT-L/14 training path -----------------------------------
    expect_counts(f"ViT-L/14 training, {1 + steps} steps", B1=per_step * (1 + steps), B2=per_step * (1 + steps))
    if not (math.isfinite(first) and math.isfinite(last)):
        raise AssertionError(f"ViT-L/14: non-finite loss {first}, {last}")
    flops = clip_flops(model, images, tokens, train=True)
    out.update(step_ms=dt * 1e3, img_s=B / dt, losses=[first, last], launches=launches, step_tflop=flops / 1e12,
               mfu=mfu(flops, dt), peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out["profile"] = device_profile(lambda: step(state, images, tokens),
                                    {"B1": B1_KERNELS, "B2": B2_KERNELS, "B2_attention": B2_ATTENTION,
                                     "port_kernels": PORT_KERNELS})
    log(f"ViT-L/14 train at {B}, bf16, --remat: {out['img_s']:.2f} img/s ({out['step_ms']:.1f} ms/step), "
        f"{out['step_tflop']:.3f} TFLOP a step, MFU {out['mfu']:.4f}, peak {out['peak_gib']:.2f} GiB, B2 "
        f"{out['profile'].get('B2_share')} of device time; launches {launches} on {card}")
    del step, state, images, tokens
    return out, model


def measure_vit_l_chunked(card: str) -> dict:
    """``grad_cache_bench`` at 512 = 8 x 64 with --remat: the direct attempt
    (a caught out-of-memory is "does not fit"), then the chunked run after
    the memory is released, launches exact in each."""
    from flyp_tpu_torch.tools import grad_cache_bench as gcb

    B, chunks, steps = VIT_L_CHUNKED
    per_step = sum(layers_of(VIT_L))
    out = {"model": VIT_L, "batch": B, "chunks": chunks, "remat": True, "device": torch.cuda.get_device_name(0)}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out["direct"] = gcb.try_direct(B, VIT_L, True)
    out["direct_launches"] = counts()
    out["direct_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if out["direct"]["fits"]:
        expect_counts(f"the direct ViT-L/14 step at {B}", B1=per_step, B2=per_step)
    gcb.release("cuda")
    torch.cuda.reset_peak_memory_stats()
    out["held_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    reset_counts()
    out["chunked"] = gcb.chunked_run(B, VIT_L, True, chunks, steps, 1)
    # Per step and chunk: B1 in the feature pass and again in the gradient
    # pass, B2 in the gradient pass (remat recomputes the MLP sub-blocks).
    expect_counts(f"the chunked ViT-L/14 step at {B} = {chunks} x {B // chunks}, {1 + steps} steps",
                  B1=2 * chunks * per_step * (1 + steps), B2=chunks * per_step * (1 + steps))
    out["chunked_launches"] = counts()
    out["chunked_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # The model's FLOPs at the global batch (the feature pass it repeats is
    # not counted), on a meta model and the bench batch's shapes.
    from flyp_tpu_torch.models import CLIPModel

    with torch.device("meta"):
        meta_model = CLIPModel(MODEL_CONFIGS[VIT_L], torch.bfloat16)
    images, tokens = bench_batch(B, MODEL_CONFIGS[VIT_L].vision.image_size)
    flops = clip_flops(meta_model, torch.from_numpy(images), torch.from_numpy(tokens), train=True)
    out.update(chunked_tflop=flops / 1e12, chunked_mfu=mfu(flops, out["chunked"]["step_time_s"]))
    if not math.isfinite(out["chunked"]["loss"]):
        raise AssertionError(f"the chunked ViT-L/14 step's loss {out['chunked']['loss']}")
    gcb.release("cuda")
    log(json.dumps({k: out[k] for k in ("model", "batch", "chunks", "remat", "device", "direct", "chunked")}))
    log(f"grad_cache_bench ViT-L/14 {B} = {chunks} x {B // chunks}: direct {out['direct']}, peak "
        f"{out['direct_peak_gib']:.2f} GiB; chunked {out['chunked']}, peak {out['chunked_peak_gib']:.2f} GiB "
        f"(held before it {out['held_gib']:.2f} GiB), {out['chunked_tflop']:.3f} TFLOP a step, MFU "
        f"{out['chunked_mfu']:.4f} on {card}")
    return out


def measure_serving(name: str, model, sizes, iters: int, card: str) -> dict:
    """``serving_bench`` over ``model`` at ``sizes`` (B3 exact), then each
    size's features held to the plain route's (phase 4's bf16 bound)."""
    from flyp_tpu_torch.tools import serving_bench

    layers_v, _ = layers_of(name)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rows = serving_bench.main(name, sizes, iters=iters, model=model)
    expect_counts(f"serving_bench {name} at {sizes}", B3=layers_v * (1 + iters) * len(sizes))
    out = {"rows": rows, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "cos_plain": {}}
    px = model.config.vision.image_size
    for bs in sizes:
        srv = ClipServer(model, image_buckets=(bs,))
        x = torch.from_numpy(np.random.default_rng(bs).standard_normal((bs, px, px, 3)).astype(np.float32))
        x = x.cuda().to(model.compute_dtype)
        reset_counts()
        out["cos_plain"][bs] = plain_cosine(srv._img_fn, x)
        expect_counts(f"{name} features at {bs}, default then plain route", B3=layers_v)
        if out["cos_plain"][bs] < 0.99:
            raise AssertionError(f"{name} features at {bs} drift from the plain route: cosine {out['cos_plain'][bs]}")
    log(f"serving_bench {name}: {rows}, peak {out['peak_gib']:.2f} GiB; least cosine to the plain route "
        f"{out['cos_plain']} on {card}")
    return out


def measure_breakdowns(card: str) -> dict:
    """``kernel_breakdown`` at ViT-L/14 and ViT-B/32 (batch 256), launches
    exact, and ``rn50_breakdown`` at 256 (plain attention: no launch)."""
    from flyp_tpu_torch.tools import kernel_breakdown, rn50_breakdown

    out = {}
    for name, kw in BREAKDOWNS.items():
        per_step = sum(layers_of(name))
        n, s = 1 + kw["iters"], 1 + kw["step_iters"]
        t0 = time.perf_counter()
        reset_counts()
        out[name] = kernel_breakdown.main(256, name, **kw)
        # Per tower: B3 (inference forward), B1 (training forward), B1 + B2
        # (forward and backward), each over n calls; then s bench steps.
        expect_counts(f"kernel_breakdown {name}", B3=2 * n, B1=4 * n + per_step * s, B2=2 * n + per_step * s)
        out[name]["s"] = time.perf_counter() - t0
        gc_cuda()
    t0 = time.perf_counter()
    reset_counts()
    out["RN50"] = {"rows": rn50_breakdown.main(256, iters=RN_BREAKDOWN_ITERS)}
    expect_counts("rn50_breakdown")
    out["RN50"]["s"] = time.perf_counter() - t0
    gc_cuda()
    log(f"breakdowns: {json.dumps(out)} on {card}")
    return out


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def measure_checks(card: str, chip_rates=None) -> dict:
    """The check tools and the A/Bs: ``convergence_check`` (the default
    route's bf16 trajectory and the plain route's), ``bf16_drift``,
    ``loop_sync_ab``, ``eval_sync_ab``, ``host_decode_bench`` and
    ``e2e_check`` (ViT-B/16 at ``TRAINER_DEPTH``, one epoch)."""
    from flyp_tpu_torch.tools import (bf16_drift, convergence_check, e2e_check, eval_sync_ab, host_decode_bench,
                                      loop_sync_ab)
    from flyp_tpu_torch.tools.bf16_drift import tool_config

    out, s = {}, {}
    tiny = tool_config()
    tiny_per_step = tiny.vision.layers + tiny.text.layers
    layers_v, layers_t = layers_of(MODEL)

    t0 = time.perf_counter()
    reset_counts()
    out["convergence"] = convergence_check.main(CONVERGENCE_STEPS, 64)
    # The default route's steps launch B1 and B2 once a block; the plain route's none.
    expect_counts("convergence_check", B1=tiny_per_step * CONVERGENCE_STEPS, B2=tiny_per_step * CONVERGENCE_STEPS)
    s["convergence"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    reset_counts()
    out["bf16_drift"] = bf16_drift.main(**DRIFT)
    expect_counts("bf16_drift (both legs on the plain route)")
    s["bf16_drift"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    reset_counts()
    out["loop_sync_ab"] = loop_sync_ab.main(256, MODEL, **SYNC_AB)
    n = 3 + 2 * SYNC_AB["blocks"] * SYNC_AB["steps"]
    expect_counts("loop_sync_ab", B1=n * (layers_v + layers_t), B2=n * (layers_v + layers_t))
    s["loop_sync_ab"] = time.perf_counter() - t0
    gc_cuda()

    t0 = time.perf_counter()
    reset_counts()
    out["eval_sync_ab"] = eval_sync_ab.main(MODEL, 256, **EVAL_AB)
    expect_counts("eval_sync_ab", B3=layers_v * (1 + 2 * EVAL_AB["blocks"] * EVAL_AB["steps"]))
    s["eval_sync_ab"] = time.perf_counter() - t0
    gc_cuda()

    t0 = time.perf_counter()
    out["host_decode"] = host_decode_bench.main(**HOST_DECODE, chip_rates=chip_rates)
    s["host_decode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
        _, cut_v, cut_t = model_shape()
        reset_counts()
        out["e2e"] = e2e_check.main(E2E_ARGV)
        launches = counts()
    # One epoch: 64 rows at batch 64 is one step; the head's prompts (2
    # classes) fit one text chunk; the 64 val images are one batch.
    expect_counts("e2e_check", B1=cut_v + cut_t, B2=cut_v + cut_t, B3=cut_t + cut_v)
    out["e2e"]["launches"] = launches
    s["e2e"] = time.perf_counter() - t0
    gc_cuda()
    out["s"] = s
    log(f"checks: convergence {out['convergence']['losses']} (plain route {out['convergence']['plain_losses']}), "
        f"bf16 drift {out['bf16_drift']}, seconds {s} on {card}")
    return out


def phase_measure(card: str, chip_rates=None) -> dict:
    """Phase 15: (a) ViT-L/14 trained and served at full width, (b) the two
    breakdowns, (c) the check tools and the A/Bs."""
    t_phase = time.perf_counter()
    out, s = {"card": card}, {}
    t0 = time.perf_counter()
    out["vit_l_train"], model = measure_vit_l_train(card)
    s["vit_l_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["vit_l_serve"] = measure_serving(VIT_L, model, *VIT_L_SERVE, card)
    del model
    gc_cuda()
    cfg = SimpleNamespace(model=VIT_L_336, clip_load=None, compute_dtype="bfloat16", seed=0)
    out["vit_l_336_serve"] = measure_serving(VIT_L_336, build_clip_model(cfg, device="cuda"), *VIT_L_336_SERVE, card)
    gc_cuda()
    s["vit_l_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["vit_l_chunked"] = measure_vit_l_chunked(card)
    s["vit_l_chunked"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["breakdowns"] = measure_breakdowns(card)
    s["breakdowns"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["checks"] = measure_checks(card, chip_rates)
    s["checks"] = time.perf_counter() - t0
    out["s"] = s
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"measure: seconds {s}; phase took {out['phase_s']:.1f} s on {card}")
    return out


def results_path(root: str, name: str) -> str:
    """The step checkpoint a run ended with (``checkpoint_0_step_{n-1}``)."""
    base = os.path.join(root, name, name)
    (key,) = os.listdir(base)
    return os.path.join(base, key, f"checkpoint_0_step_{PARALLEL_STEPS - 1}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_rank_main(out_dir: str, name: str, argv_json: str) -> int:
    """One rank of a multi-card run under torchrun (``--parallel-rank``)."""
    from flyp_tpu_torch.cli import main as cli_main

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    use_impl("auto")
    rank = int(os.environ["RANK"])
    if name == "tp":
        # The group outlives the run here, for the head built after it.
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    try:
        with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
            ret = _rank_counts(out_dir, rank, name, lambda: _planted(
                name, lambda: cli_main.main(cli_main.parse_main_arguments(json.loads(argv_json)))))
            if name == "tp":
                _tp_head(out_dir, rank, ret)
    finally:
        if name == "tp":
            dist.destroy_process_group()
    return 0


def main() -> int:
    if "--parallel-rank" in sys.argv[1:]:
        i = sys.argv.index("--parallel-rank")
        return parallel_rank_main(*sys.argv[i + 1:i + 4])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    peaks = card_peaks(card)

    t0 = time.perf_counter()
    built = _kernels.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _kernels.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if "--digests" in sys.argv[1:]:
        log(json.dumps({"card": card, "digests": digests()}))
        return 0
    if "--attention-times" in sys.argv[1:]:
        log(json.dumps({"card": card, "attention_times": attention_times(), "long_rows": long_row_cases(peaks)}))
        return 0
    if "--default-route" in sys.argv[1:]:
        use_impl("auto")
        log(json.dumps({"card": card, "default_route": default_route_rates(card)}))
        return 0
    if "--gemm" in sys.argv[1:]:
        log(json.dumps({"card": card, "gemm": phase_gemm(peaks)}))
        return 0
    if "--input" in sys.argv[1:]:
        use_impl("auto")
        synthetic = bench_training(build_clip_model(SimpleNamespace(model=MODEL, clip_load=None,
                                                                    compute_dtype="bfloat16", seed=0),
                                                    device="cuda"), "pallas_block", card)[-1]["train_img_s"]
        log(json.dumps({"card": card, "input": phase_input(card, synthetic)}))
        return 0
    if "--eval" in sys.argv[1:]:
        use_impl("auto")
        log(json.dumps({"card": card, "evaluation": phase_evaluation(card)}))
        return 0
    if "--trainer" in sys.argv[1:]:
        use_impl("auto")
        with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
            log(json.dumps({"card": card, "trainer": phase_trainer(card)}))
        return 0
    if "--resnet" in sys.argv[1:]:
        use_impl("auto")
        log(json.dumps({"card": card, "resnet": phase_resnet(card)}))
        return 0
    if "--parallel" in sys.argv[1:] or "--parallel-trainer" in sys.argv[1:]:
        use_impl("auto")
        log(json.dumps({"card": card, "parallel": phase_parallel(card, peaks, "--parallel" in sys.argv[1:])}))
        return 0
    if "--research" in sys.argv[1:]:
        use_impl("auto")
        log(json.dumps({"card": card, "research": phase_research(card)}))
        return 0
    if "--surface" in sys.argv[1:]:
        use_impl("auto")
        cfg = SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="bfloat16", seed=0)
        srv = ClipServer.for_classification(build_clip_model(cfg, device="cuda"), CLASSNAMES, simple_template,
                                            image_buckets=BUCKETS)
        srv.warmup()  # as phase 4's server is when phase 14 (a) meets it
        http = surface_http(srv, card)
        del srv
        torch.cuda.empty_cache()
        log(json.dumps({"card": card, "surface": phase_surface(card, http)}))
        return 0
    if "--measure" in sys.argv[1:]:
        use_impl("auto")
        log(json.dumps({"card": card, "measure": phase_measure(card)}))
        return 0

    # The default route ("auto", the fused block) for the phases before the
    # route phase, whatever the environment says.
    use_impl("auto")
    gemm_cases = phase_gemm(peaks)
    cases = phase_kernels(peaks)
    fwd_cases, bwd_cases = phase_train_kernels(peaks)
    impl_cases = phase_impl_kernels(peaks)
    long_rows = long_row_cases(peaks)
    with tempfile.TemporaryDirectory() as tmp:
        serving = phase_serving(tmp, card)
    training = phase_training(card)
    input_phase = phase_input(card, training["train_img_s"])
    # The default route's numbers come from the serving and training phases.
    impls = {"pallas_block": {**{k: training[k] for k in ("train_img_s", "step_ms", "loss", "train_launches",
                                                          "layers_train_ms", "layers_eval_ms", "profile")},
                              "serve_img_s": serving["img_s"][BUCKETS[-1]]},
             **phase_impls(card)}
    probes, tools = phase_probes(peaks), phase_tools()
    use_impl("auto")
    evaluation = phase_evaluation(card)
    with cut_depth(MODEL, **TRAINER_DEPTH[MODEL]):
        trainer = phase_trainer(card)
    resnet = phase_resnet(card)
    use_impl("auto")
    parallel = phase_parallel(card, peaks)
    shard_cases = parallel["kernels"]
    use_impl("auto")
    research = phase_research(card)
    use_impl("auto")
    surface = phase_surface(card, serving["http"])
    use_impl("auto")
    measure = phase_measure(card, {"ViT-B/16 bs256": training["train_img_s"],
                                   "RN50 bs256": resnet["bench"]["train_img_s"]})

    def line(name, source, replaces, launches, cases, pick=None, long=None):
        # B1-B6 are reported at the main path's vision shape, T1-T4 at the
        # case ``pick`` names; ``long`` lists an attention kernel's calls at
        # ViT-L/14's rows (LONG_ROW_SHAPES, the streamed route).  B5, B6 and
        # T1-T4 (T4 in fp32 moments) compute what one PyTorch call computes
        # (library_ms); no single call computes B1-B4, so their library_ms is
        # null and a composite yardstick stands beside.
        c = next(c for c in cases if (pick(c) if pick else (c["B"], c["L"], c["dtype"]) == MAIN_SHAPE
                                                        and "shards" not in c))
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": c.get("library_ms"), "composite_ms": c.get("composite_ms"),
                **{k: c[k] for k in ("attention_ms", "sdpa_ms") if k in c},
                "shape": c.get("shape") or f"B={c['B']} L={c['L']} D={c['D']} H={c['H']} {c['dtype']}",
                "cases": cases, **({"long_rows": long} if long else {})}

    def route(impl, kernel):  # launches on the route's 13-step training path
        return impls[impl]["train_launches"][kernel]

    def tool(kernel):  # launches on the ported tools' paths
        return sum(t["launches"].get(kernel, 0) for t in tools.values())

    gemm = "flyp_tpu_torch/csrc/probe_gemm.cu"
    sm90 = "flyp_tpu_torch/csrc/gemm_sm90.cuh"  # T2's and T3's kernel (entries score_depth.cu, probe_gemm.cu)

    kernels = [
        line("attention_block_inference", "flyp_tpu_torch/csrc/attention_block.cu",
             "flyp_tpu/ops/attention_block.py:303", serving["launches"], cases + shard_cases["B3"],
             long=long_rows["B3"]),
        line("attention_block_train_forward", "flyp_tpu_torch/csrc/attention_block.cu",
             "flyp_tpu/ops/attention_block.py:118", route("pallas_block", "B1"), fwd_cases + shard_cases["B1"],
             long=long_rows["B1"]),
        line("attention_block_train_backward", "flyp_tpu_torch/csrc/attention_block_bwd.cu",
             "flyp_tpu/ops/attention_block.py:185", route("pallas_block", "B2"), bwd_cases + shard_cases["B2"],
             long=long_rows["B2"]),
        line("mlp_block_forward", "flyp_tpu_torch/csrc/mlp_block.cu", "flyp_tpu/ops/mlp_block.py:45",
             route("pallas_block_mlp", "B4"), impl_cases["B4"]),
        line("fused_qkv_attention_forward", "flyp_tpu_torch/csrc/attention.cu",
             "flyp_tpu/ops/fused_qkv_attention.py:62", route("pallas_qkv", "B5_fwd"), impl_cases["B5_fwd"],
             long=long_rows["B5_fwd"]),
        line("fused_qkv_attention_backward", "flyp_tpu_torch/csrc/attention.cu",
             "flyp_tpu/ops/fused_qkv_attention.py:74", route("pallas_qkv", "B5_bwd"), impl_cases["B5_bwd"],
             long=long_rows["B5_bwd"]),
        line("flash_attention_forward", "flyp_tpu_torch/csrc/attention.cu", "flyp_tpu/ops/flash_attention.py:36",
             route("pallas", "B6_fwd"), impl_cases["B6_fwd"], long=long_rows["B6_fwd"]),
        line("flash_attention_backward", "flyp_tpu_torch/csrc/attention.cu", "flyp_tpu/ops/flash_attention.py:53",
             route("pallas", "B6_bwd"), impl_cases["B6_bwd"], long=long_rows["B6_bwd"]),
        line("probe_gemm_bf16", gemm, "tools/int8_matmul_probe.py:73", tool("T1_bf16"), probes["T1_bf16"],
             lambda c: c["shape"].startswith("qkv")),
        line("probe_gemm_int8", gemm, "tools/int8_matmul_probe.py:73", tool("T1_int8"), probes["T1_int8"],
             lambda c: c["shape"].startswith("qkv")),
        line("score_depth", sm90, "tools/mfu_levers.py:102", tool("T2"), probes["T2"],
             lambda c: (c["hd"], c["L"]) == (64, 208)),
        line("row_quant_gemm", sm90, "tools/mfu_levers.py:145", tool("T3"), probes["T3"], lambda c: c["R"] == 197),
        line("adamw_update", "flyp_tpu_torch/csrc/adamw.cu", "tools/mfu_levers.py:229", tool("T4"), probes["T4"],
             lambda c: c["moments"] == "float32"),
    ]
    log(json.dumps({"card": card, "img_s": serving["img_s"], "cos_fp32": serving["cos_fp32"],
                    "cos_bf16": serving["cos_bf16"], "breakdown": serving["breakdown"]}))
    log(json.dumps({"card": card, "training": training}))
    log(json.dumps({"card": card, "input": input_phase}))
    log(json.dumps({"card": card, "routes": impls}))
    log(json.dumps({"card": card, "tools": tools}))
    log(json.dumps({"card": card, "gemm": gemm_cases}))
    log(json.dumps({"card": card, "evaluation": evaluation}))
    log(json.dumps({"card": card, "trainer": trainer}))
    log(json.dumps({"card": card, "resnet": resnet}))
    log(json.dumps({"card": card, "parallel": {k: v for k, v in parallel.items() if k != "kernels"}}))
    log(json.dumps({"card": card, "research": research}))
    log(json.dumps({"card": card, "surface": surface}))
    log(json.dumps({"card": card, "measure": measure}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
