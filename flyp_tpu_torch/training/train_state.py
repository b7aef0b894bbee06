"""Train state: the model (its parameters) and the AdamW state.

Counterpart of ``flyp_tpu/training/train_state.py``.  The optimizer is
FLYP's: torch-default AdamW hyperparameters (betas 0.9/0.999, eps 1e-8) with
decoupled weight decay on *every* parameter, LN scales and ``logit_scale``
included (the reference passes a single param group).  The learning rate is
``schedule(count)`` with ``count`` the number of updates applied so far,
starting at 0, as ``optax.inject_hyperparams`` evaluates it.

Unlike the JAX package's pure functions, the update runs in place: the
parameters (and a ModifiedResNet's BatchNorm running statistics, JAX's
``batch_stats``) live in the model, and the moments and the count are updated
where they lie, with ``torch._foreach_*`` ops on the parameters' device.
The count and the rate stay on that device too, so a step never waits on the
host.

On a mesh (``parallel/``) the state says where its tensors rest: ``mesh``,
and ``layout`` ``{name: (axis, dim)}`` for every parameter that is split
along ``dim`` over the mesh axis ``axis``.  Under tensor parallelism
(``parallel/tp.py::shard_train_state``) the model's parameters are this
rank's shards and the moments follow them.  Under FSDP
(``parallel/fsdp.py::shard_train_state_fsdp``) ``shards`` holds this rank's
piece of every parameter, the moments follow the shards, and the model's
whole parameters exist only between ``materialize`` and ``release``.  The
step, the count and the scalars replicate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from flyp_tpu_torch.models.clip import CLIPModel


def _f32(v: float) -> float:
    """``v`` rounded to float32 (optax injects the hyperparameters as float32
    arrays, so ``1 - b2`` is a float32 difference)."""
    return float(torch.tensor(v, dtype=torch.float32))


B1, B2, EPS = _f32(0.9), _f32(0.999), _f32(1e-8)


_MOMENT_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16,
                  torch.float32: torch.float32, torch.bfloat16: torch.bfloat16}


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor  # int32 scalar: updates applied so far
    mu: List[torch.Tensor]  # first moments, one per parameter, in the moment type
    nu: List[torch.Tensor]  # second moments


class AdamW:
    """AdamW with fp32 arithmetic and moments stored in fp32 or bf16.

    ``moment_dtype`` None/"float32" keeps the moments in fp32 (the exact
    optax ``adamw``); "bfloat16" stores them rounded to bf16 after each
    update, all arithmetic still in fp32 (the JAX package's
    ``_scale_by_adam_moment_dtype``), halving the optimizer state's memory
    and traffic.  ``torch.optim.AdamW`` has no bf16-moment mode, so the
    update is written out here."""

    def __init__(self, schedule: Callable, weight_decay: float, moment_dtype=None):
        if moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be float32 or bfloat16, got {moment_dtype!r}")
        self.schedule = schedule
        self.weight_decay = _f32(weight_decay)
        self.moment_dtype = _MOMENT_DTYPES[moment_dtype]

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        params = list(params)
        device = params[0].device
        zeros = lambda: [torch.zeros_like(p, dtype=self.moment_dtype) for p in params]  # noqa: E731
        return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device), mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: AdamWState,
               frozen: Optional[Sequence[bool]] = None) -> torch.Tensor:
        """One AdamW step in place over ``params`` (fp32) with ``grads``;
        parameters flagged in ``frozen`` keep their values (their moments
        still take the given grads).  Returns the rate used, on the device."""
        params, grads = list(params), [g.float() for g in grads]
        lr = torch.as_tensor(self.schedule(state.count), dtype=torch.float32, device=state.count.device)
        fp32 = self.moment_dtype == torch.float32
        m32 = state.mu if fp32 else [m.float() for m in state.mu]
        v32 = state.nu if fp32 else [v.float() for v in state.nu]
        torch._foreach_mul_(m32, B1)
        torch._foreach_add_(m32, grads, alpha=_f32(1.0 - B1))
        torch._foreach_mul_(v32, B2)
        torch._foreach_addcmul_(v32, grads, grads, value=_f32(1.0 - B2))
        if not fp32:
            torch._foreach_copy_(state.mu, m32)
            torch._foreach_copy_(state.nu, v32)
        state.count.add_(1)
        count = state.count.float()
        bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
        denom = torch._foreach_div(v32, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(m32, bc1)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_mul_(updates, -lr)
        if frozen is not None:
            keep = [i for i, f in enumerate(frozen) if not f]
            params, updates = [params[i] for i in keep], [updates[i] for i in keep]
        torch._foreach_add_(params, updates)
        return lr


def make_optimizer(schedule: Callable, weight_decay: float, moment_dtype=None) -> AdamW:
    """AdamW with torch-default hyperparameters; see :class:`AdamW`."""
    return AdamW(schedule, weight_decay, moment_dtype)


@dataclasses.dataclass
class TrainState:
    step: int
    model: CLIPModel
    opt_state: AdamWState
    mesh: Optional[object] = None
    layout: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    shards: Optional[List[torch.Tensor]] = None  # FSDP: this rank's piece of each parameter
    full_shapes: Dict[str, tuple] = dataclasses.field(default_factory=dict)  # FSDP: each parameter's shape
    materialized: bool = True  # FSDP: the model holds the whole parameters

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    @property
    def update_targets(self) -> List[torch.Tensor]:
        """What the optimizer updates: the FSDP shards, else the parameters."""
        return self.shards if self.shards is not None else self.params

    @property
    def batch_stats(self) -> Optional[Dict[str, torch.Tensor]]:
        """The BatchNorm running statistics (the model's buffers) by name,
        or None for a tower without BatchNorm.  The train step updates them
        in place; the optimizer never sees them."""
        return dict(self.model.named_buffers()) or None


def create_train_state(model: CLIPModel, optimizer: AdamW) -> TrainState:
    """The model in training mode with every parameter requiring grad, and
    fresh optimizer state on its device."""
    model.train().requires_grad_(True)
    return TrainState(step=0, model=model, opt_state=optimizer.init(model.parameters()))
