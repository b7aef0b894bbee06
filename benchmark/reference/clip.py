"""Plain PyTorch reference of what the timed paths compute: OpenAI CLIP's
ViT image tower and causal text tower (openai/CLIP ``clip/model.py``), the
symmetric InfoNCE loss of CLIP and FLYP, AdamW with decoupled weight decay
on every parameter (``torch.optim.AdamW``'s update, written out), and the
normalising zero-shot head.

It imports nothing of the program under test.  Weights arrive as a dict of
float32 tensors in the layout the benchmark makes them (``weights.py``):
``qkv_kernel [3, D, D]`` is q|k|v on the leading axis, the patch kernel is
HWIO.  Every product goes through ``mm``/``bmm`` of a :class:`Precision`:

* ``Precision("float32")``: float32 with TF32 off, the reference proper;
* ``Precision("float8")``: each operand of every product, forward and
  backward, rounded to float8 e4m3 with a per-tensor scale (amax to 448),
  accumulated in float32.  It is the control: the same reference one
  precision step below the bfloat16 that the configurations state.

Tokens come at the full context length (77) and the tower attends over all
of it: the program's shrinking of the context to the batch's EOT width is
worked out again here, not taken over.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, as float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, _E4M3_MAX / amax, torch.ones_like(amax))
    return ((t.float() * scale).to(torch.float8_e4m3fn).float()) / scale


class _Fp8MatMul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to float8 in the forward, and
    the incoming gradient and both operands rounded in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # Undo the broadcast of a 2-D weight over leading batch axes.
        while db.dim() > qb.dim():
            db = db.sum(0)
        return da, db


class Precision:
    """The arithmetic of the reference's products (module docstring)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"precision must be float32 or float8, got {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "float8":
            return _Fp8MatMul.apply(a, b)
        return torch.matmul(a, b)


FP32 = Precision("float32")


def no_tf32() -> None:
    """Float32 products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, w, prefix):
    return F.layer_norm(x, (x.shape[-1],), w[prefix + ".scale"], w[prefix + ".bias"], 1e-5)


def residual_block(x, w, prefix, heads, causal, prec: Precision):
    """Pre-LN block: ``x + attn(ln_1(x))``, then ``x + mlp(ln_2(x))`` with
    QuickGELU (CLIP's ``ResidualAttentionBlock``)."""
    B, L, D = x.shape
    hd = D // heads
    y = layer_norm(x, w, prefix + ".ln_1")
    wqkv, bqkv = w[prefix + ".attn.qkv_kernel"], w[prefix + ".attn.qkv_bias"]
    q, k, v = (
        (prec.mm(y, wqkv[t]) + bqkv[t]).reshape(B, L, heads, hd).transpose(1, 2) for t in range(3)
    )
    s = prec.mm(q * hd ** -0.5, k.transpose(-1, -2))
    if causal:
        s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool, device=x.device).tril(), float("-inf"))
    o = prec.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, L, D)
    x = x + prec.mm(o, w[prefix + ".attn.out_kernel"]) + w[prefix + ".attn.out_bias"]
    h = prec.mm(layer_norm(x, w, prefix + ".ln_2"), w[prefix + ".mlp.fc_kernel"]) + w[prefix + ".mlp.fc_bias"]
    h = h * torch.sigmoid(1.702 * h)
    return x + prec.mm(h, w[prefix + ".mlp.proj_kernel"]) + w[prefix + ".mlp.proj_bias"]


def encode_image(w, images, cfg, prec: Precision = FP32):
    """``images`` ``[B, H, W, 3]`` -> unnormalised ``[B, embed_dim]``: a
    stride-``patch`` convolution, class token, positions, ``ln_pre``, the
    blocks, ``ln_post`` on the class token, the projection."""
    v = cfg["vision"]
    p, width = v["patch_size"], v["width"]
    x = images.float().permute(0, 3, 1, 2)  # NCHW
    kernel = w["visual.patch_kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    if prec.name == "float32":
        x = F.conv2d(x, kernel, stride=p)
        x = x.flatten(2).transpose(1, 2)  # [B, N, width]
    else:  # the same convolution as a product of patches, so it can be rounded
        B, C, H, W_ = x.shape
        patches = x.reshape(B, C, H // p, p, W_ // p, p).permute(0, 2, 4, 1, 3, 5).reshape(B, -1, C * p * p)
        x = prec.mm(patches, kernel.reshape(width, C * p * p).T)
    cls = w["visual.class_embedding"].expand(x.shape[0], 1, width)
    x = torch.cat([cls, x], dim=1) + w["visual.positional_embedding"]
    x = layer_norm(x, w, "visual.ln_pre")
    for i in range(v["layers"]):
        x = residual_block(x, w, f"visual.transformer.block_{i}", v["heads"], False, prec)
    x = layer_norm(x[:, 0], w, "visual.ln_post")
    return prec.mm(x, w["visual.proj"])


def encode_text(w, tokens, cfg, prec: Precision = FP32):
    """``tokens`` ``[B, 77]`` -> unnormalised ``[B, embed_dim]``, pooled at
    the end-of-text token (the highest id)."""
    t = cfg["text"]
    tokens = tokens.long()
    x = w["text.token_embedding"][tokens] + w["text.positional_embedding"][: tokens.shape[1]]
    for i in range(t["layers"]):
        x = residual_block(x, w, f"text.transformer.block_{i}", t["heads"], True, prec)
    x = layer_norm(x, w, "text.ln_final")
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return prec.mm(pooled, w["text.text_projection"])


def normalize(x):
    return x / x.norm(dim=-1, keepdim=True)


def contrastive_loss(img_f, txt_f, logit_scale):
    """Mean over the batch of the two directions' cross entropy, halved."""
    logits = logit_scale.exp() * img_f @ txt_f.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def zero_shot_logits(w, head, images, cfg, prec: Precision = FP32):
    """The head over L2-normalised image features: ``[n, classes]``."""
    return prec.mm(normalize(encode_image(w, images, cfg, prec)), head.T)


def loss_and_grads(w, images, tokens, cfg, prec: Precision = FP32, rows: int = 32):
    """(loss, {name: gradient}) of the contrastive loss over the whole batch,
    worked out in blocks of ``rows`` rows so that it fits: the features of
    every row first, the loss and its gradient in the features, then each
    block's forward again with its share of that gradient."""
    names = list(w)
    B = images.shape[0]
    with torch.no_grad():
        img = torch.cat([normalize(encode_image(w, images[i:i + rows], cfg, prec)) for i in range(0, B, rows)])
        txt = torch.cat([normalize(encode_text(w, tokens[i:i + rows], cfg, prec)) for i in range(0, B, rows)])
    img.requires_grad_(True)
    txt.requires_grad_(True)
    scale = w["logit_scale"].detach().clone().requires_grad_(True)
    loss = contrastive_loss(img, txt, scale)
    d_img, d_txt, d_scale = torch.autograd.grad(loss, [img, txt, scale])
    params = {n: w[n].detach().clone().requires_grad_(True) for n in names}
    grads = {n: torch.zeros_like(w[n]) for n in names}
    for i in range(0, B, rows):
        f_img = normalize(encode_image(params, images[i:i + rows], cfg, prec))
        f_txt = normalize(encode_text(params, tokens[i:i + rows], cfg, prec))
        part = (f_img * d_img[i:i + rows]).sum() + (f_txt * d_txt[i:i + rows]).sum()
        used = [n for n in names if n != "logit_scale"]
        for n, g in zip(used, torch.autograd.grad(part, [params[n] for n in used], allow_unused=True)):
            if g is not None:
                grads[n] += g
    grads["logit_scale"] = d_scale.reshape(w["logit_scale"].shape)
    return loss.detach(), grads


class AdamW:
    """``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8, decoupled
    weight decay on every parameter, float32 moments; ``lr(count)`` with
    ``count`` the updates already applied."""

    def __init__(self, names: Sequence[str], like: Dict[str, torch.Tensor], lr, weight_decay: float):
        self.lr, self.wd, self.count = lr, weight_decay, 0
        self.m = {n: torch.zeros_like(like[n]) for n in names}
        self.v = {n: torch.zeros_like(like[n]) for n in names}

    @torch.no_grad()
    def step(self, w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for n, g in grads.items():
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + 1e-8) + self.wd * w[n]
            w[n].sub_(lr * update)


def cosine_lr(base: float, warmup: int, total: int):
    """FLYP's schedule: linear warmup ``base (step + 1) / warmup``, then a
    cosine from ``base`` to 0 over the remaining steps."""

    def lr(step: int) -> float:
        if step < warmup:
            return base * (step + 1) / max(warmup, 1)
        return 0.5 * (1 + math.cos(math.pi * (step - warmup) / max(total - warmup, 1))) * base

    return lr


def train_readings(w, batches: List[tuple], cfg, opt_cfg, prec: Precision = FP32, rows: int = 32):
    """The reference's side of a training cell's comparison, from the
    initial weights ``w`` (updated in place) over ``batches`` of (images,
    tokens): each step's loss, the first step's gradient and the change of
    every parameter after the last step."""
    start = {n: t.clone() for n, t in w.items()}
    opt = AdamW(list(w), w, cosine_lr(opt_cfg["lr"], opt_cfg["warmup"], opt_cfg["total_steps"]),
                opt_cfg["weight_decay"])
    losses, first_grad = [], None
    for images, tokens in batches:
        loss, grads = loss_and_grads(w, images, tokens, cfg, prec, rows)
        losses.append(float(loss))
        if first_grad is None:
            first_grad = grads
        opt.step(w, grads)
        del grads
    change = {n: w[n] - start[n] for n in w}
    return losses, first_grad, change
