"""Per-component step-time breakdown on the card.

Counterpart of ``tools/kernel_breakdown.py``.  Times the pieces of a train
step alone: the attention block's training forward (B1) and forward +
backward (B1 + B2) and its inference forward (B3), at the vision and text
shapes; the plain MLP block's forward + backward; the AdamW update over the
whole model's state; and the whole bench step (``tools/_bench.py``, remat
for ViT-L).  Each piece is timed with CUDA events after a warm-up
(``tools/_timing.py``).  Multiplied by the layer counts, the rows
reconstruct the measured step; the residual is the fixed tails (patch and
token embeddings, final LayerNorms and projections, the loss, casts).

``--device cpu`` runs the plain versions, a functional check; the CLI's
sizes are the card's and take long there, so call :func:`main` with a
small ``batch`` and ``iters``.

Usage: python -m flyp_tpu_torch.tools.kernel_breakdown [batch] [model] [--device cuda|cpu]
e.g. ``python -m flyp_tpu_torch.tools.kernel_breakdown 512 ViT-B/32``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.ops.attention_block import attention_block, attention_block_inference
from flyp_tpu_torch.tools._bench import build_bench_parts, build_bench_step, compute_dtype
from flyp_tpu_torch.tools._timing import normal, time_call

# (vision L, D, H, layers), (text L, D, H, layers) per family.  Text at the
# shrunk context (L=32): prompt-templated captions bucket to ~32 slots.
# Pinned equal to the JAX tool's table by tests/test_torch_tools_measure.py.
SHAPES = {
    "ViT-B/16": ((197, 768, 12, 12), (32, 512, 8, 12)),
    "ViT-B/32": ((50, 768, 12, 12), (32, 512, 8, 12)),
    "ViT-L/14": ((257, 1024, 16, 24), (32, 768, 12, 12)),
}


def mlp(x, w1, w2):
    """The plain MLP block at the JAX tool's rounding points: LN in fp32
    (no affine), fc, QuickGELU, proj, the residual."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    h = y @ w1.to(x.dtype)
    h = h * torch.sigmoid(1.702 * h)
    return x + h @ w2.to(x.dtype)


def _grads(loss_fn, inputs):
    return torch.autograd.grad(loss_fn(*inputs), inputs)


def block_rows(batch, name, L, D, H, layers, dtype, device, rng, iters):
    """(row name, seconds, layers) of the attention block's three calls and
    the MLP block's forward + backward at one tower's shape."""
    causal = name == "text"
    x = normal(rng, (batch, L, D), dtype, device)
    p = [torch.ones(D, device=device), torch.zeros(D, device=device),
         normal(rng, (3, D, D), torch.float32, device) * D ** -0.5, torch.zeros(3, D, device=device),
         normal(rng, (D, D), torch.float32, device) * D ** -0.5, torch.zeros(D, device=device)]
    args = [x, *p]
    with torch.inference_mode():
        t_infer = time_call(lambda *a: attention_block_inference(*a, H, causal), *args, iters=iters)
    with torch.no_grad():
        t_fwd = time_call(lambda *a: attention_block(*a, H, causal), *args, iters=iters)
    leaves = [a.detach().requires_grad_(True) for a in args]
    t_fb = time_call(lambda *a: _grads(lambda *b: attention_block(*b, H, causal).float().square().sum(), a),
                     *leaves, iters=iters)
    w1 = (normal(rng, (D, 4 * D), torch.float32, device) * D ** -0.5).requires_grad_(True)
    w2 = (normal(rng, (4 * D, D), torch.float32, device) * D ** -0.5).requires_grad_(True)
    xg = x.detach().requires_grad_(True)
    t_mlp = time_call(lambda *a: _grads(lambda *b: mlp(*b).float().square().sum(), a), xg, w1, w2, iters=iters)
    return [(f"attn block {name} infer fwd", t_infer, layers), (f"attn block {name} fwd", t_fwd, layers),
            (f"attn block {name} fwd+bwd", t_fb, layers), (f"mlp block {name} fwd+bwd", t_mlp, layers)]


def main(batch=256, model_name="ViT-B/16", device="cuda", iters=30, step_iters=10) -> dict:
    """The rows, the measured step and the residual, in seconds."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if compute_dtype(device) == "bfloat16" else torch.float32
    rng = np.random.default_rng(0)
    if model_name not in SHAPES:
        raise SystemExit(
            f"kernel_breakdown: no per-block shape table for {model_name!r}; "
            f"supported: {sorted(SHAPES)} (transformer towers only; ResNet "
            f"families have their own tools/rn50_breakdown.py)"
        )
    (vL, vD, vH, vlayers), (tL, tD, tH, tlayers) = SHAPES[model_name]
    rows = []
    for name, L, D, H, layers in (("vision", vL, vD, vH, vlayers), ("text", tL, tD, tH, tlayers)):
        rows += block_rows(batch, name, L, D, H, layers, dtype, device, rng, iters)

    # The AdamW update over the whole model's state, bf16 moments as the
    # bench's (FLYP_ADAM_MOMENT_DTYPE), gradients of ones; the update writes
    # the parameters and both moments in place, as the step's does.
    moment_dtype = os.environ.get("FLYP_ADAM_MOMENT_DTYPE", "bfloat16")
    model, optimizer, state, _, _, _ = build_bench_parts(8, model_name, False, device)
    grads = [torch.ones_like(p) for p in state.params]
    t_opt = time_call(lambda: optimizer.update(state.params, grads, state.opt_state), iters=iters)
    n_params = sum(p.numel() for p in state.params) / 1e6
    rows.append((f"adamw update ({n_params:.0f}M params, {moment_dtype} moments)", t_opt, 1))
    del model, optimizer, state, grads

    # The whole bench step, same session: the residual after the towers
    # and the update is the fixed tails.
    step_fn, state_b, images, tokens, _ = build_bench_step(batch, model_name, model_name.startswith("ViT-L"), device)

    def step():
        nonlocal state_b
        state_b, m = step_fn(state_b, images, tokens)
        return m["loss"]

    t_step = time_call(step, iters=step_iters)

    total = 0.0
    for name, t, mult in rows:
        counted = "fwd+bwd" in name or "adamw" in name
        share = t * mult / t_step * 100 if counted else 0.0
        tag = f"  ({share:4.1f}% of step)" if counted else ""
        print(f"{name:>40s}: {t*1e3:7.2f} ms x{mult:<3d} = {t*mult*1e3:7.1f} ms{tag}")
        if counted:
            total += t * mult
    resid = t_step - total
    print(f"{'full train step (measured)':>40s}: {t_step*1e3:7.1f} ms   ({batch / t_step:.0f} img/s)")
    print(f"{'residual = fixed tails':>40s}: {resid*1e3:7.1f} ms  ({resid / t_step * 100:.1f}% of step)")
    sys.stdout.flush()
    return {"rows": [{"name": n, "s": t, "layers": m} for n, t, m in rows], "step_s": t_step, "residual_s": resid}


def cli(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=256)
    parser.add_argument("model", nargs="?", default="ViT-B/16")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    return main(args.batch, args.model, device=args.device)


if __name__ == "__main__":
    cli()
