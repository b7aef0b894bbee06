"""The general traffic generator: every input of a run, made from the seed
and the parameters of the mix's file (``benchmark/traffic/<mix>.json``).

* Training batches: images standard normal ``[B, px, px, 3]`` drawn in the
  compute type on the device; captions of ``caption_tokens`` tokens
  (start token, random ids from ``vocab_ids``, end token, zeros after) at
  the full context length, as the data path feeds them before the program
  shrinks them to the batch's width.  ``distinct_batches`` batches, cycled.
* Serving: an image pool of ``pool_images`` float32 images on the host, and
  requests of log-uniform sizes from ``sizes.min`` to ``sizes.max``, each a
  slice of the pool at an offset drawn from the seed.  Sizes come in blocks
  of ``sizes.strata``: one size from the middle of each equal-probability
  stratum, shuffled within the block.  Arrivals are an open loop at
  ``rate`` requests a second: the gaps between them are exponential, drawn
  the same way (the middles of ``arrivals.strata`` equal-probability
  strata, shuffled within each block).  The shuffles come from the mix's
  ``trace_seed``, not the run's: every seed replays one trace of sizes and
  arrival times, on its own images and weights.  A tail over a few hundred
  requests moves by a third between shuffles, so a shuffle per seed would
  measure the shuffle.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

SOT, EOT = 49406, 49407


def _generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))


def captions(batch: int, context: int, lengths: Tuple[int, int], ids: Tuple[int, int], gen, device):
    """``[batch, context]`` int32 token ids: start token, ``n - 1`` random
    ids and the end token at ``n``, with ``n`` uniform in ``lengths`` (the
    upper end excluded)."""
    n = torch.randint(lengths[0], lengths[1], (batch, 1), generator=gen, device=device)
    body = torch.randint(ids[0], ids[1], (batch, context), generator=gen, device=device)
    pos = torch.arange(context, device=device)[None, :]
    tokens = torch.where(pos < n, body, torch.zeros_like(body))
    tokens = torch.where(pos == n, torch.full_like(body, EOT), tokens)
    tokens[:, 0] = SOT
    return tokens.to(torch.int32)


def train_batches(cfg: dict, mix: dict, seed: int, device, dtype, count: int = 0, rows=None) -> List[tuple]:
    """The first ``count`` (default all ``distinct_batches``) training
    batches, (images ``[B, px, px, 3]`` in ``dtype``, tokens ``[B, 77]``
    int32); ``rows`` (a slice) keeps those rows of each batch."""
    px, B = cfg["vision"]["image_size"], mix["batch"]
    out = []
    for i in range(count or mix["distinct_batches"]):
        gen = _generator(seed, 100 + i, device)
        images = torch.randn((B, px, px, 3), generator=gen, device=device, dtype=torch.float32).to(dtype)
        tokens = captions(B, cfg["text"]["context_length"], tuple(mix["caption_tokens"]),
                          tuple(mix["vocab_ids"]), gen, device)
        if rows is not None:
            images, tokens = images[rows], tokens[rows]
        out.append((images, tokens))
    return out


def image_pool(cfg: dict, mix: dict, seed: int, device):
    """``[pool_images, px, px, 3]`` float32 images, drawn on ``device`` and
    handed to the host as a numpy array."""
    px = cfg["vision"]["image_size"]
    gen = _generator(seed, 7, device)
    return torch.randn((mix["pool_images"], px, px, 3), generator=gen, device=device).cpu().numpy()


def request_sizes(mix: dict, seed: int, count: int) -> List[int]:
    """``count`` request sizes, log-uniform in blocks (module docstring)."""
    lo, hi, k = math.log(mix["sizes"]["min"]), math.log(mix["sizes"]["max"]), mix["sizes"]["strata"]
    block = [int(round(math.exp(lo + (j + 0.5) / k * (hi - lo)))) for j in range(k)]
    return _blocks(block, count, torch.Generator().manual_seed(int(seed) % (2 ** 63)))


def requests(mix: dict, seed: int, count: int) -> List[Tuple[int, int]]:
    """``count`` requests (pool offset, size): the trace's sizes, the
    seed's offsets."""
    sizes = request_sizes(mix, mix["trace_seed"], count)
    gen = torch.Generator().manual_seed((int(seed) + 11) % (2 ** 63))
    return [(int(torch.randint(0, mix["pool_images"] - n + 1, (1,), generator=gen)), n) for n in sizes]


def _blocks(values: List[float], count: int, gen: torch.Generator) -> List[float]:
    """``values`` repeated in blocks, each block shuffled by ``gen``."""
    out = []
    while len(out) < count:
        out += [values[j] for j in torch.randperm(len(values), generator=gen).tolist()]
    return out[:count]


def arrival_times(mix: dict, count: int) -> List[float]:
    """Seconds after the window opens at which the trace's first ``count``
    requests are due (module docstring)."""
    k = mix["arrivals"]["strata"]
    gaps = [-math.log(1 - (j + 0.5) / k) / mix["rate"] for j in range(k)]
    gen = torch.Generator().manual_seed((int(mix["trace_seed"]) + 31) % (2 ** 63))
    t, out = 0.0, []
    for g in _blocks(gaps, count, gen):
        t += g
        out.append(t)
    return out
