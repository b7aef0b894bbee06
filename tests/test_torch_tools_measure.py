"""The port's FLOP count and MFU (``flyp_tpu_torch/utils/profiling.py``)
and its measurement tools (``flyp_tpu_torch/tools/``) against the JAX
package's.

The count is held to the closed form ``2 M N K`` exactly on a linear layer
and an attention block, and to JAX's ``compiled_flops`` (XLA's cost
analysis) of the ``xla`` route on the same tiny model; ``kernel_breakdown``'s
shape table is pinned to the JAX tool's; every other tool runs at
``__graft_entry__._tiny_config``'s size on the CPU (``device="cpu"``: the
kernels' plain versions), its output keys equal to the JAX tool's (each
expected key is also checked to stand in the JAX tool's source).  The
trajectories of ``convergence_check`` and ``bf16_drift`` are
``tests/test_torch_tools_trajectory.py``'s.
"""

import json
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.ops.attention import _IMPL_ENV
from flyp_tpu.ops.attention import _default_impl as jax_default_impl
from flyp_tpu.training.schedules import warmup_cosine_lr as jax_warmup_cosine_lr
from flyp_tpu.training.train_state import create_train_state as jax_create_train_state
from flyp_tpu.training.train_state import make_optimizer as jax_make_optimizer
from flyp_tpu.training.train_step import make_train_step as jax_make_train_step
from flyp_tpu.utils.profiling import compiled_flops as jax_compiled_flops
from flyp_tpu_torch.entry import _tiny_config as port_tiny_config
from flyp_tpu_torch.models import MODEL_CONFIGS, CLIPModel
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.models.layers import _matmul
from flyp_tpu_torch.models.resnet import Dense
from flyp_tpu_torch.ops import attention as port_attention
from flyp_tpu_torch.ops.attention_block import attention_block_inference_reference
from flyp_tpu_torch.tools import (e2e_check, eval_sync_ab, grad_cache_bench, host_decode_bench, kernel_breakdown,
                                  loop_sync_ab, rn50_breakdown, serving_bench)
from flyp_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_source(tool: str) -> str:
    return (REPO / "tools" / f"{tool}.py").read_text()


def assert_in_jax_source(tool: str, keys):
    """Each expected key stands quoted in the JAX tool's source."""
    src = jax_source(tool)
    missing = [k for k in keys if f'"{k}"' not in src and f"'{k}'" not in src]
    assert not missing, f"{missing} not in tools/{tool}.py"


def last_json(text: str) -> dict:
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# ---------------------------------------------------------------------------
# The FLOP count.


@pytest.mark.parametrize("M,K,N", [(7, 64, 96), (256, 768, 3072)])
def test_a_linear_layer_counts_2mnk(M, K, N):
    x = meta(M, K)
    assert profiling.compiled_flops(_matmul, x, meta(K, N)) == 2 * M * N * K
    with torch.device("meta"):
        dense = Dense(K, N)
    assert profiling.compiled_flops(dense, x) == 2 * M * N * K


@pytest.mark.parametrize("causal", [False, True])
def test_an_attention_block_counts_its_closed_form(causal):
    """QKV, the scores, p @ v and the out-projection at ``2 M N K`` each (a
    causal mask does not shrink the plain route's products); the backward
    to every input is twice the forward."""
    B, L, D, H = 3, 17, 128, 2
    want = 2 * B * L * D * 3 * D + 2 * (2 * B * H * L * L * (D // H)) + 2 * B * L * D * D
    args = [meta(B, L, D, grad=True), meta(D, grad=True), meta(D, grad=True), meta(3, D, D, grad=True),
            meta(3, D, grad=True), meta(D, D, grad=True), meta(D, grad=True)]
    assert profiling.compiled_flops(attention_block_inference_reference, *args, H, causal) == want

    def fwd_bwd():
        out = attention_block_inference_reference(*args, H, causal)
        return torch.autograd.grad(out.sum(), args)

    assert profiling.compiled_flops(fwd_bwd) == 3 * want


def _port_config(jcfg) -> CLIPConfig:
    import dataclasses

    d = dataclasses.asdict(jcfg)
    return CLIPConfig(embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


@pytest.fixture
def jax_xla_route():
    before = os.environ.get(_IMPL_ENV)
    os.environ[_IMPL_ENV] = "xla"
    jax_default_impl.cache_clear()
    yield
    if before is None:
        os.environ.pop(_IMPL_ENV, None)
    else:
        os.environ[_IMPL_ENV] = before
    jax_default_impl.cache_clear()


# XLA's cost analysis also counts elementwise work (LayerNorm, softmax,
# GELU, the loss, AdamW's ~10 operations a parameter), the port's count
# products alone; at this width (128) that is ~2% of XLA's forward count
# and ~8% of its train step's.  So the port's count lies at or below XLA's,
# and above these shares of it.
FLOP_SHARE = {"forward": 0.95, "train_step": 0.88}


@pytest.mark.parametrize("what", ["forward", "train_step"])
def test_the_count_matches_jax_compiled_flops(what, jax_xla_route):
    jcfg = _tiny_config()
    jmodel = JaxCLIPModel(jcfg)
    B, ctx = 4, 16
    images = jax.ShapeDtypeStruct((B, 64, 64, 3), jnp.float32)
    tokens = jax.ShapeDtypeStruct((B, ctx), jnp.int32)
    params = jax.eval_shape(lambda: init_clip_params(jmodel, 0))
    if what == "forward":
        fn = jax.jit(lambda p, i, t: jmodel.apply({"params": p}, i, t, train=False))
        want = jax_compiled_flops(fn, params, images, tokens)
    else:
        opt = jax_make_optimizer(jax_warmup_cosine_lr(1e-3, 2, 10), weight_decay=0.1)
        state = jax.eval_shape(lambda: jax_create_train_state(init_clip_params(jmodel, 0), opt))
        want = jax_compiled_flops(jax_make_train_step(jmodel, opt, donate=False), state, images, tokens)
    with torch.device("meta"):
        model = CLIPModel(_port_config(jcfg))
    got = profiling.clip_flops(model, meta(B, 64, 64, 3), meta(B, ctx, dtype=torch.int32),
                               train=what == "train_step")
    assert FLOP_SHARE[what] * want <= got <= want, (got, want, got / want)


def test_the_count_leaves_remat_out_and_keeps_the_route():
    """A remat model counts as the model does (the twin is built without
    remat), and the caller's route comes back after the count."""
    cfg = port_tiny_config()
    with torch.device("meta"):
        plain, remat = CLIPModel(cfg), CLIPModel(cfg, remat=True)
    images, tokens = meta(2, 64, 64, 3), meta(2, 16, dtype=torch.int32)
    os.environ[port_attention._IMPL_ENV] = "pallas_block"
    port_attention._default_impl.cache_clear()
    try:
        assert profiling.clip_flops(remat, images, tokens, train=True) == \
            profiling.clip_flops(plain, images, tokens, train=True) > 0
        assert port_attention._default_impl() == "pallas_block"
        assert profiling.meta_twin(remat).remat is False
    finally:
        os.environ.pop(port_attention._IMPL_ENV, None)
        port_attention._default_impl.cache_clear()


def test_peaks_and_mfu(monkeypatch):
    import chip_smoke

    assert profiling.card_peaks("NVIDIA H100 80GB HBM3")[torch.bfloat16] == 989e12
    assert profiling.card_peaks("NVIDIA H100 PCIe")[torch.bfloat16] == 756e12
    assert profiling.device_peak_flops("cpu") is None and profiling.mfu(1e12, 1.0, "cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiling.device_peak_flops("cuda") == 989e12
    assert profiling.mfu(989e12 / 2, 1.0, "cuda") == pytest.approx(0.5)
    # chip_smoke.py reads the table here; it keeps no copy of its own.
    assert chip_smoke.card_peaks is profiling.card_peaks and not hasattr(chip_smoke, "PEAKS")


# ---------------------------------------------------------------------------
# The tools.


def test_kernel_breakdown_shapes_equal_jax():
    from tools.kernel_breakdown import SHAPES as JAX_SHAPES

    assert kernel_breakdown.SHAPES == JAX_SHAPES


@pytest.fixture
def tiny_model(monkeypatch):
    """``TINY`` in the port's configurations (the JAX tests' tiny CLIP) and
    in ``kernel_breakdown``'s shape table; the real vocabulary and context,
    as the bench's captions and the tokenizer need."""
    cfg = port_tiny_config(real_text=True)
    monkeypatch.setitem(MODEL_CONFIGS, "TINY", cfg)
    seq = (cfg.vision.image_size // cfg.vision.patch_size) ** 2 + 1
    monkeypatch.setitem(kernel_breakdown.SHAPES, "TINY", ((seq, cfg.vision.width, cfg.vision.heads, cfg.vision.layers),
                                                          (32, cfg.text.width, cfg.text.heads, cfg.text.layers)))
    return "TINY"


GCB_KEYS = {"model", "batch", "chunks", "remat", "device", "direct", "chunked"}
GCB_DIRECT = {"fits", "first_step_s", "loss"}
GCB_CHUNKED = {"step_time_s", "img_per_s", "loss"}


def test_grad_cache_bench_smoke(tiny_model, capsys):
    out = grad_cache_bench.main(["--model", tiny_model, "--device", "cpu"])
    printed = last_json(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert set(out) == GCB_KEYS and set(out["direct"]) == GCB_DIRECT and set(out["chunked"]) == GCB_CHUNKED
    assert_in_jax_source("grad_cache_bench", GCB_KEYS | GCB_DIRECT | GCB_CHUNKED | {"oom", "error"})
    assert (out["batch"], out["chunks"], out["device"]) == (8, 2, "cpu") and out["direct"]["fits"]
    assert np.isfinite(out["chunked"]["loss"]) and out["chunked"]["img_per_s"] > 0


def test_grad_cache_bench_records_only_running_out_of_memory(monkeypatch):
    def oom(*args):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(grad_cache_bench, "direct_step", oom)
    got = grad_cache_bench.try_direct(8, "ViT-L/14", True, "cpu")
    assert got["fits"] is False and got["oom"] is True and "out of memory" in got["error"]

    def fault(*args):
        raise RuntimeError("a launch failed")

    monkeypatch.setattr(grad_cache_bench, "direct_step", fault)
    with pytest.raises(RuntimeError, match="a launch failed"):
        grad_cache_bench.try_direct(8, "ViT-L/14", True, "cpu")


SERVING_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
SERVING_EXTRA = {"per_batch", "device", "attn_impl"}
SERVING_ROW = {"img_per_s", "latency_ms", "fwd_mfu", "fwd_tflops"}


def test_serving_bench_smoke(tiny_model, capsys):
    rows = serving_bench.main(tiny_model, (8, 256), classes=7, device="cpu")
    out = last_json(capsys.readouterr().out)
    assert set(out) == SERVING_KEYS and set(out["extra"]) == SERVING_EXTRA
    assert_in_jax_source("serving_bench", SERVING_KEYS | SERVING_EXTRA | SERVING_ROW)
    assert list(rows) == [8] and set(rows[8]) == SERVING_ROW  # off the card: one batch of at most 8
    assert rows[8]["fwd_mfu"] is None and out["vs_baseline"] is None  # no peak is claimed for a CPU
    cfg = MODEL_CONFIGS[tiny_model]
    with torch.device("meta"):
        model = CLIPModel(cfg)
    flops = profiling.clip_flops(model, meta(8, 64, 64, 3), head_classes=7)
    assert rows[8]["fwd_tflops"] == round(flops / 1e12, 3) and flops > 0


def test_kernel_breakdown_smoke(tiny_model, capsys):
    res = kernel_breakdown.main(4, tiny_model, device="cpu", iters=1, step_iters=1)
    text = capsys.readouterr().out
    names = [r["name"] for r in res["rows"]]
    for tower in ("vision", "text"):
        for row in ("attn block {} fwd", "attn block {} fwd+bwd", "mlp block {} fwd+bwd", "attn block {} infer fwd"):
            assert row.format(tower) in names
    assert any(n.startswith("adamw update (") for n in names)
    for line in ("full train step (measured)", "residual = fixed tails"):
        assert line in text and line in jax_source("kernel_breakdown")
    assert res["step_s"] > 0


def test_rn50_breakdown_smoke(capsys):
    """The tiny RN of the JAX tests (32 px, width 16, blocks 1-1-1-1): every
    piece's row, the pieces' FLOPs summing to the tower's."""
    from types import SimpleNamespace

    from flyp_tpu_torch.models import build_clip_model

    cfg = CLIPConfig(embed_dim=64, vision=VisionConfig(image_size=32, width=16, patch_size=None, layers=0, heads=8,
                                                       resnet_layers=(1, 1, 1, 1)),
                     text=TextConfig(context_length=32, vocab_size=1024, width=128, heads=2, layers=2))
    model = build_clip_model(SimpleNamespace(model="RN50", clip_load=None, compute_dtype="float32", seed=0),
                             config_override=cfg, device="cpu")
    rows = rn50_breakdown.main(4, device="cpu", iters=1, model=model)
    src = jax_source("rn50_breakdown")
    labels = [r["name"] for r in rows]
    assert all(f'"{label}"' in src for label in labels[:-1]) and labels[-1] == "TOWER fwd+bwd total"
    assert len(labels) == 7 and "TOWER fwd+bwd total" in capsys.readouterr().out
    assert all(r["gflop"] > 0 and r["peak_share"] is None for r in rows)
    assert sum(r["gflop"] for r in rows[:-1]) == pytest.approx(rows[-1]["gflop"])


def test_loop_sync_ab_smoke(tiny_model, capsys):
    blocks = loop_sync_ab.main(4, tiny_model, device="cpu")
    assert "sync/lagged" in capsys.readouterr().out and "sync/lagged" in jax_source("loop_sync_ab")
    assert len(blocks) == 1 and blocks[0]["ratio"] > 0


def test_eval_sync_ab_smoke(tiny_model, capsys):
    blocks = eval_sync_ab.main(tiny_model, 4, classes=7, device="cpu")
    assert "sync/lagged" in capsys.readouterr().out and "sync/lagged" in jax_source("eval_sync_ab")
    assert len(blocks) == 1 and blocks[0]["ratio"] > 0


HOST_KEYS = {"metric", "us_per_image", "img_per_s_per_core", "native_over_pil_train_jpeg", "cores_per_chip"}
HOST_PATHS = {f"{a}_{b}_{c}" for a in ("native", "pil") for b in ("train", "eval") for c in ("jpeg", "png")}


def test_host_decode_bench_smoke(capsys):
    out = host_decode_bench.main(2, 32, 1)
    assert last_json(capsys.readouterr().out) == out
    assert set(out) == HOST_KEYS and set(out["us_per_image"]) == HOST_PATHS == set(out["img_per_s_per_core"])
    assert_in_jax_source("host_decode_bench", HOST_KEYS)
    assert set(out["cores_per_chip"]) == set(host_decode_bench.CHIP_RATES)
    assert all(v > 0 for v in out["us_per_image"].values())


def test_e2e_check_smoke(tiny_model, capsys):
    got = e2e_check.main(["--epochs", "1", "--batch-size", "4", "--images-per-class", "4", "--model", tiny_model,
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "full-trainer e2e check OK" in out and "epoch losses:" in out and "epoch losses:" in jax_source("tpu_e2e_check")
    assert got["checkpoint"] == "checkpoint_0" and len(got["losses"]) == 1 and np.isfinite(got["losses"][0])


def test_e2e_check_fails_on_a_non_finite_loss(tiny_model, monkeypatch):
    """A run whose stats hold a NaN loss fails the check (a non-zero exit)."""
    from flyp_tpu_torch.cli import main as cli_main

    def fake(cfg):
        cfg.log_dir = os.path.join("expt_logs", "e2e", "run")
        cfg.save = os.path.join(cfg.save, "e2e", "run")
        os.makedirs(cfg.log_dir)
        os.makedirs(os.path.join(cfg.save, "checkpoint_0"))
        with open(os.path.join(cfg.log_dir, "stats.tsv"), "w") as f:
            f.write("\tAvg ID FLYP Loss\tPatchCamelyonVal Accuracy\n0\tnan\t0.5\n")
        return os.path.join(cfg.save, "checkpoint_0")

    monkeypatch.setattr(cli_main, "main", fake)
    with pytest.raises(RuntimeError, match="non-finite epoch losses"):
        e2e_check.main(["--epochs", "1", "--images-per-class", "1", "--model", tiny_model, "--device", "cpu"])
