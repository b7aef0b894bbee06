"""Roofline bounds of the attention-block calls (B1, B2, B3): the least
time the card could take, max(operations / peak, bytes / bandwidth), each
input byte read once and each output byte written once.

B1 (training forward) and B3 (inference forward) compute ``x +
out_proj(attention(LN(x) Wqkv + b))``: QKV, scores and ``p @ v`` (half the
``L^2`` work under the causal mask) and the out-projection; bytes: x read
and the output written, the four ``D x D`` matrices read.  B2 (training
backward): ``2BLD^2`` for ``do``, ``12BLD^2`` for ``dWqkv`` and ``dY``,
``10BL^2D`` for the five ``L x L`` products (halved when causal); bytes:
x, g, q, k, v read and dx written, lse, the four matrices, and the fp32
``dWqkv``, ``dbqkv``, ``dscale`` and ``dbias``.  ``dWout`` is not B2's
work: the program computes it outside the kernel.
"""

from __future__ import annotations

EL = 2  # bytes of a bf16 element


def forward_s(B: int, L: int, D: int, causal: bool, peaks: dict) -> float:
    """Seconds of one B1 or B3 call."""
    flops = 2 * B * L * D * 3 * D + 4 * B * L * L * D * (0.5 if causal else 1.0) + 2 * B * L * D * D
    nbytes = 2 * B * L * D * EL + 4 * D * D * EL
    return max(flops / peaks["bf16"], nbytes / peaks["bytes"])


def backward_s(B: int, L: int, D: int, H: int, causal: bool, peaks: dict) -> float:
    """Seconds of one B2 call."""
    flops = 14 * B * L * D * D + 10 * B * L * L * D * (0.5 if causal else 1.0)
    nbytes = 6 * B * L * D * EL + B * L * H * 4 + 4 * D * D * EL + (3 * D * D + 5 * D) * 4
    return max(flops / peaks["bf16"], nbytes / peaks["bytes"])


def block_calls(cfg: dict, batch: int, text_len: int = 0):
    """(B, L, D, heads, causal, count) of the blocks one pass runs: the
    vision tower's, and the text tower's when ``text_len`` is given."""
    v, t = cfg["vision"], cfg["text"]
    calls = [(batch, (v["image_size"] // v["patch_size"]) ** 2 + 1, v["width"], v["heads"], False, v["layers"])]
    if text_len:
        calls.append((batch, text_len, t["width"], t["heads"], True, t["layers"]))
    return calls


def train_step_s(cfg: dict, batch: int, text_len: int, peaks: dict) -> float:
    """The bound of one train step's B1 and B2 calls, both towers."""
    return sum(n * (forward_s(B, L, D, c, peaks) + backward_s(B, L, D, H, c, peaks))
               for B, L, D, H, c, n in block_calls(cfg, batch, text_len))


def serve_forward_s(cfg: dict, bucket: int, peaks: dict) -> float:
    """The bound of one image forward's B3 calls at ``bucket`` rows."""
    return sum(n * forward_s(B, L, D, c, peaks) for B, L, D, H, c, n in block_calls(cfg, bucket))
