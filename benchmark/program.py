"""The system under test, built from a configuration's file: the
``flyp_tpu_torch`` model with the benchmark's weights, its train step and
its server.  The only module here, with ``yardstick/kernels.py``, that
imports the program."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_kernels() -> None:
    """The program's CUDA libraries, built into its cache inside the
    checkout on a first run and found there after."""
    from flyp_tpu_torch.ops import _kernels

    _kernels.build_all()


def model(cfg: dict, weights: dict, device, remat: bool = False):
    """A ``CLIPModel`` of ``cfg``'s sizes holding copies of ``weights``."""
    from flyp_tpu_torch.models import CLIPConfig, CLIPModel, TextConfig, VisionConfig

    v, t = cfg["vision"], cfg["text"]
    config = CLIPConfig(
        embed_dim=cfg["embed_dim"],
        vision=VisionConfig(image_size=v["image_size"], width=v["width"], patch_size=v["patch_size"],
                            layers=v["layers"], heads=v["heads"]),
        text=TextConfig(context_length=t["context_length"], vocab_size=t["vocab_size"], width=t["width"],
                        heads=t["heads"], layers=t["layers"]),
    )
    with torch.device(device):
        m = CLIPModel(config, DTYPES[cfg["compute_dtype"]], remat=remat)
    m.load_state_dict(weights, strict=True)
    return m.eval().requires_grad_(False)


def train_step(m, cfg: dict, opt: dict):
    """(step_fn, state): FLYP's step on the default route, AdamW with the
    configuration's moment type on the mix's schedule."""
    from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr

    optimizer = make_optimizer(warmup_cosine_lr(opt["lr"], opt["warmup"], opt["total_steps"]),
                               weight_decay=opt["weight_decay"], moment_dtype=cfg["moment_dtype"])
    state = create_train_state(m, optimizer)
    return make_train_step(m, optimizer), state


def shrink(tokens: torch.Tensor) -> torch.Tensor:
    """The program's cut of a token batch to its bucketed end-token width
    (host side, as its data path does it)."""
    from flyp_tpu_torch.tokenizer import shrink_context

    return torch.from_numpy(shrink_context(tokens.cpu().numpy())).to(tokens.device)


def counters() -> dict:
    """The program's kernel launch counters."""
    from flyp_tpu_torch.ops import attention_block as ab
    from flyp_tpu_torch.ops import flash_attention, fused_qkv_attention, mlp_block

    out = {"b1": ab.attention_block.fwd_launches, "b2": ab.attention_block.bwd_launches,
           "b3": ab.attention_block_inference.launches}
    for name, fn in (("b4", mlp_block.mlp_block), ("b5", fused_qkv_attention.fused_qkv_attention),
                     ("b6", flash_attention.flash_attention)):
        out[name] = sum(v for k, v in vars(fn).items() if "launches" in k and isinstance(v, int))
    return out


def server(m, head_weight: torch.Tensor, buckets, window: int):
    """A ``ClipServer`` with a normalising head of ``head_weight``'s rows."""
    from flyp_tpu_torch.models import ClassificationHead
    from flyp_tpu_torch.serving import ClipServer

    head = ClassificationHead(head_weight.float().clone(), normalize=True).to(head_weight.device)
    return ClipServer(m, head=head, image_buckets=tuple(buckets), window=window)
