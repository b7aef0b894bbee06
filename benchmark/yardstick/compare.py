"""The numbers that decide ``correct``: each reads how far the program's
outputs lie from the reference's, and is held to the cell's limit in
``benchmark/limits/<workload>.json``.

Training (the first steps of the object the window drives, against the
reference from the same weights and batches):

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: over the leaves, the widest gap between the norms of the
  first gradient (as the optimizer holds it after one step), against the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same of the parameters' change over the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a key's bias has a gradient of nought under softmax and
  moves by round-off alone under Adam).

A leaf is a parameter, and a stacked ``qkv`` parameter's q, k and v each.

Serving (a sample of the window's finished requests, each row against the
reference's logits of the same images):

* ``logit_err``: the widest gap of any logit, in the logits' own units
  (cosines with the head's unit rows).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch


def leaves(named: Iterable) -> Dict[str, torch.Tensor]:
    """{leaf: tensor} of (name, tensor) pairs; stacked q|k|v split."""
    out = {}
    for name, t in named:
        if name.endswith(("qkv_kernel", "qkv_bias")):
            for i, part in enumerate("qkv"):
                out[f"{name}.{part}"] = t[i]
        else:
            out[name] = t
    return out


def leaf_norms(named: Iterable) -> Dict[str, float]:
    """{leaf: float32 norm}, one fetch from the device."""
    items = list(leaves(named).items())
    norms = torch.stack([t.detach().float().norm() for _, t in items]).cpu().tolist()
    return {name: n for (name, _), n in zip(items, norms)}


def median(values):
    v = sorted(values)
    return v[len(v) // 2]


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median ref)."""
    med = median(ref.values())
    names = [n for n in ref if keep is None or n in keep]
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def moving_leaves(ref_grad: Dict[str, float]) -> set:
    """Leaves whose reference gradient is at least 1e-3 of the median's."""
    med = median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= 1e-3 * med}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``/``ref``: {"losses": [...], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    steps = min(len(prog["losses"]), len(ref["losses"]))
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][:steps], ref["losses"][:steps]))
    return {
        "loss_gap": loss_gap,
        "grad_gap": norm_gap(prog["grad"], ref["grad"]),
        "change_gap": norm_gap(prog["change"], ref["change"], moving_leaves(ref["grad"])),
    }


def serve_numbers(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """``prog``, ``ref``: ``[rows, classes]`` float32 logits."""
    return {"logit_err": float((prog.float() - ref.float()).abs().max())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a number that is not finite fails)."""
    return all(n in numbers and numbers[n] == numbers[n] and numbers[n] <= lim for n, lim in limits.items())
