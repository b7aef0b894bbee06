#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``flyp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build every CUDA kernel of the package from ``flyp_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version at the serving path's
   shapes, in fp32 (TF32 off) and bf16, timed with CUDA events beside the
   plain version, a composite PyTorch yardstick and the card's bound;
4. the serving slice at full ViT-B/16 width in bf16: ``ClipServer.
   from_checkpoint`` on a random-init ``.pt`` written by the port's own
   converter, a zero-shot head, warmup, classify / top_k / encode_texts /
   stream_logits requests with the kernel's launch count checked exactly,
   features held against the CPU plain forward, and img/s at buckets 64 and
   256.

The line before the last is a JSON object of per-kernel numbers; the last
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flyp_tpu_torch.models import build_clip_model, convert  # noqa: E402
from flyp_tpu_torch.ops import _kernels  # noqa: E402
from flyp_tpu_torch.ops import attention_block as ab  # noqa: E402
from flyp_tpu_torch.serving import ClipServer  # noqa: E402
from flyp_tpu_torch.templates import simple_template  # noqa: E402

MODEL = "ViT-B/16"
BUCKETS = (8, 64, 256)
CLASSNAMES = ["cat", "dog", "school bus", "golden retriever", "tench"]
# Kernel vs plain: fp32 sums in another order (1e-4); bf16 additionally
# may flip a rounding inside q/k/v/p/o, a few bf16 ulps of O(1) outputs.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Dense peaks (NVIDIA data sheets): bf16 tensor cores, fp32 CUDA cores, HBM.
PEAKS = {
    "sxm": {torch.bfloat16: 989e12, torch.float32: 67e12, "bytes": 3.35e12},
    "pcie": {torch.bfloat16: 756e12, torch.float32: 51e12, "bytes": 2.0e12},
}


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


def phase_kernels(peaks) -> list:
    cases = []
    shapes = [(64, 197, 768, 12, False), (64, 16, 512, 8, True), (64, 77, 512, 8, True)]
    for B, L, D, H, causal in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = block_inputs(B, L, D, dtype, seed=L)
            with torch.inference_mode():
                out = ab.attention_block_inference(*args, H, causal)
                torch.cuda.synchronize()
                ref = ab.attention_block_inference_reference(*args, H, causal)
                err = (out.float() - ref.float()).abs()
                tol = TOL[dtype]
                bad = int((err > tol + tol * ref.float().abs()).sum())
                if not bool(torch.isfinite(out).all()) or bad:
                    raise AssertionError(f"kernel disagrees at {(B, L, D, H, causal, dtype)}: "
                                         f"{bad} elements past {tol}, max abs err {err.max().item()}")
                ms = cuda_ms(lambda: ab.attention_block_inference(*args, H, causal))
                plain_ms = cuda_ms(lambda: ab.attention_block_inference_reference(*args, H, causal))
                composite_ms = cuda_ms(lambda: yardstick(*args, H, causal))
            bound_ms, bound_by = block_bound_ms(B, L, D, causal, dtype, peaks)
            case = dict(B=B, L=L, D=D, H=H, causal=causal, dtype=str(dtype).split(".")[-1],
                        max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, composite_ms=composite_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            cases.append(case)
            log("kernel", json.dumps(case))
    return cases


def chunks(n: int) -> int:
    return math.ceil(n / BUCKETS[-1])


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_serving(tmp: str, card: str) -> dict:
    from types import SimpleNamespace

    t0 = time.perf_counter()
    cfg = SimpleNamespace(model=MODEL, clip_load=None, compute_dtype="float32", seed=0)
    cpu_model = build_clip_model(cfg, device="cpu")
    ckpt = os.path.join(tmp, "vit_b16_random.pt")
    convert.save_torch_checkpoint(ckpt, convert.export_clip_state_dict(cpu_model.state_dict(), cpu_model.config))
    log(f"random-init {MODEL} written to a .pt in {time.perf_counter() - t0:.1f} s")

    layers_v, layers_t = cpu_model.config.vision.layers, cpu_model.config.text.layers
    px = cpu_model.config.vision.image_size
    rng = np.random.default_rng(0)
    ab.attention_block_inference.launches = 0
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
    launches = ab.attention_block_inference.launches
    # ---- end of the main path -------------------------------------------
    if launches != expected:
        raise AssertionError(f"attention-block kernel launched {launches} times, expected {expected}")
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
    breakdown = profile_request(srv, batch)
    return {"launches": launches, "cos_fp32": float(cos32.min()), "cos_bf16": float(cos16.min()), "img_s": rates,
            "breakdown": breakdown}


def profile_request(srv: ClipServer, batch: np.ndarray) -> dict:
    """Device time by kernel over one classify request (torch.profiler):
    the attention-block kernels' share, the busy share of the request's
    wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.classify(batch)
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
    ours = sum(d for d, k in rows if re.search(r"(gemm|attention)_(mma|fma)_kernel", k))
    out = {"rows": len(batch), "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "busy_share": busy / wall_us, "attention_block_share": ours / busy,
           "top": [[k[:80], d / 1e3] for d, k in rows[:8]]}
    log("profile " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    peaks = PEAKS["pcie" if "pcie" in card.lower() else "sxm"]

    t0 = time.perf_counter()
    built = _kernels.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _kernels.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cases = phase_kernels(peaks)
    with tempfile.TemporaryDirectory() as tmp:
        serving = phase_serving(tmp, card)

    main_case = next(c for c in cases if c["L"] == 197 and c["dtype"] == "bfloat16")
    kernels = [{
        "name": "attention_block_inference",
        "route": "cuda",
        "source": "flyp_tpu_torch/csrc/attention_block.cu",
        "replaces": "flyp_tpu/ops/attention_block.py:303",
        "launches": serving["launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "composite_ms": main_case["composite_ms"],
        "shape": "B=64 L=197 D=768 H=12 bf16",
        "cases": cases,
    }]
    log(json.dumps({"card": card, "img_s": serving["img_s"], "cos_fp32": serving["cos_fp32"],
                    "cos_bf16": serving["cos_bf16"], "breakdown": serving["breakdown"]}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
