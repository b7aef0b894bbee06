"""Training sanity on the card: the tiny CLIP, N steps; the loss must fall
from near the InfoNCE floor ln(batch) and follow the plain route.

Counterpart of ``tools/tpu_convergence_check.py``.  It shows a kernel's
backward end to end in real training on the card (bf16, the default route:
B1 and B2 in every block): the parity tests hold the kernels to the plain
versions call by call; this holds the trained trajectory.

On the card the same trajectory runs twice in bf16: on the default route
and on the plain route (``FLYP_ATTENTION_IMPL=xla``), from the same init
and data.  Checks (each raises):

* the first loss lies in ``(ln B - 0.3, ln B + 2)`` (random features at
  ``logit_scale = 1/0.07`` sit at or above the chance floor; far below
  means a bug), and the last is at least 0.5 below the first;
* at every recorded step the two routes' losses lie within
  :data:`ROUTE_BOUND` of each other.  The routes round to bf16 at the
  same points but sum in other orders, which can flip a rounding: a few
  bf16 ulps of the loss (one ulp is 2^-6 = 0.016 near ln 64 = 4.16).  A
  wrong gradient changes the trajectory by far more.

``--device cpu`` runs the default route alone in fp32 (there the kernels'
plain versions run, so a second route would repeat the same products).
The model, data and schedule are ``bf16_drift``'s (the JAX tools').

Usage: python -m flyp_tpu_torch.tools.convergence_check [steps] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import time

from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.tools.bf16_drift import build, data
from flyp_tpu_torch.utils.profiling import plain_route

ROUTE_BOUND = 0.1  # |loss(default route) - loss(plain route)| at every recorded step, bf16


def trajectory(steps: int, batch: int, dtype_name: str, device, state_dict=None) -> list:
    """[(step, loss)] at every 20th step and the last."""
    model, state, step_fn = build(dtype_name, steps, batch, device, state_dict)
    images, tokens = data(batch, device)
    losses = []
    for i in range(steps):
        state, metrics = step_fn(state, images, tokens)
        if i % 20 == 0 or i == steps - 1:
            losses.append((i, float(metrics["loss"])))
            print(f"step {i}: loss {losses[-1][1]:.4f}", flush=True)
    return losses


def main(steps: int = 120, batch: int = 64, device="cuda", state_dict=None) -> dict:
    device = resolve_device(device)
    on_card = device.type == "cuda"
    dtype_name = "bfloat16" if on_card else "float32"
    t0 = time.perf_counter()
    losses = trajectory(steps, batch, dtype_name, device, state_dict)
    dt = time.perf_counter() - t0

    first, last = losses[0][1], losses[-1][1]
    floor = math.log(batch)
    print(f"init ~{first:.3f} (ln {batch} = {floor:.3f}), final {last:.3f}, {dt:.1f}s")
    if not floor - 0.3 < first < floor + 2.0:
        raise AssertionError(f"init loss {first} vs ln(batch) {floor}")
    if not last < first - 0.5:
        raise AssertionError(f"no convergence: {first} -> {last}")
    out = {"losses": losses, "s": dt, "plain_losses": None, "max_route_divergence": None}
    if on_card:
        print("the plain route, from the same init:", flush=True)
        with plain_route():
            plain = trajectory(steps, batch, dtype_name, device, state_dict)
        gaps = [abs(a - b) for (_, a), (_, b) in zip(losses, plain)]
        out.update(plain_losses=plain, max_route_divergence=max(gaps))
        print(f"default route against the plain route: largest gap {max(gaps):.5f} (bound {ROUTE_BOUND})")
        if max(gaps) > ROUTE_BOUND:
            raise AssertionError(f"the default route's trajectory leaves the plain route's: {losses} vs {plain}")
    print("CONVERGENCE OK")
    return out


def cli(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("steps", nargs="?", type=int, default=120)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return main(args.steps, device=args.device)


if __name__ == "__main__":
    cli()
