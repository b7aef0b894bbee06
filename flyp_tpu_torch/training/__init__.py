"""FLYP's contrastive train step: schedules, AdamW state, the step and its
chunked (GradCache) form."""

from .schedules import crestart_lr, make_scheduler, warmup_cosine_lr
from .train_state import AdamW, AdamWState, TrainState, create_train_state, make_optimizer
from .train_step import make_train_step
from .grad_cache import make_chunked_train_step

__all__ = [
    "AdamW",
    "AdamWState",
    "TrainState",
    "create_train_state",
    "crestart_lr",
    "make_chunked_train_step",
    "make_optimizer",
    "make_scheduler",
    "make_train_step",
    "warmup_cosine_lr",
]
