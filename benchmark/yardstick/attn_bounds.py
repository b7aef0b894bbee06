"""Roofline bounds of the attention step alone inside the attention-block
calls (B1, B2, B3): max(operations / peak, bytes / bandwidth) of the
``L x L`` products and of each input and output of the attention kernels
read or written once, at any head width.  The projections, LayerNorm and
the weight gradients around them are ``bounds.py``'s.

A call on ``B`` rows of ``L`` tokens, ``D = heads x head_dim`` wide:

* forward (B1, B3): ``s = q k^T`` and ``p v``, ``4 B L^2 D`` operations
  (half under the causal mask); q, k, v read and o written, ``4 B L D``
  bf16 elements, and B1's ``lse``, ``B L heads`` fp32 values, written;
* backward (B2's two passes): ``s``, ``dp = do v^T``, ``dv = p^T do``,
  ``dq = ds k`` and ``dk = ds^T q``, ``10 B L^2 D`` operations (half under
  the mask); q, k, v and ``do`` read and dq, dk, dv written, ``7 B L D``
  bf16 elements, and ``lse`` read.

The kernels' own scratch between their passes (the rows' ``delta``) and
their recomputation of ``s`` are not the step's work, so they are left
out.
"""

from __future__ import annotations

EL = 2  # bytes of a bf16 element
F32 = 4


def forward(B: int, L: int, D: int, heads: int, causal: bool, train: bool) -> tuple:
    """(operations, bytes) of one forward's attention step."""
    ops = 4 * B * L * L * D * (0.5 if causal else 1.0)
    nbytes = 4 * B * L * D * EL + (B * L * heads * F32 if train else 0)
    return ops, nbytes


def backward(B: int, L: int, D: int, heads: int, causal: bool) -> tuple:
    """(operations, bytes) of one backward's attention step."""
    ops = 10 * B * L * L * D * (0.5 if causal else 1.0)
    nbytes = 7 * B * L * D * EL + B * L * heads * F32
    return ops, nbytes


def seconds(ops: float, nbytes: float, peaks: dict) -> float:
    return max(ops / peaks["bf16"], nbytes / peaks["bytes"])


# The program's spans of the attention-block calls and the kernel launches
# of the streamed route that each call makes.
SPANS = {"attn.block_fwd": ("b1", "forward"), "attn.block_infer": ("b3", "forward"),
         "attn.block_bwd": ("b2", "backward")}


def span_seconds(span: dict, peaks: dict) -> float:
    """The bound of the attention step of one ``attn.block_*`` span, from
    its attributes."""
    a = span["attrs"]
    args = (a["B"], a["L"], a["D"], a["heads"], bool(a["causal"]))
    if SPANS[span["name"]][1] == "forward":
        return seconds(*forward(*args, train=span["name"] == "attn.block_fwd"), peaks)
    return seconds(*backward(*args), peaks)
