"""Serving: bucketed, pipelined CLIP inference (see engine.py)."""

from flyp_tpu_torch.serving.engine import ClipServer

__all__ = ["ClipServer"]
