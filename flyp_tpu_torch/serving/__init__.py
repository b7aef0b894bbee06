"""Serving: bucketed, pipelined CLIP inference (see engine.py) and the
stdlib HTTP front-end (http.py)."""

from flyp_tpu_torch.serving.engine import ClipServer
from flyp_tpu_torch.serving.http import serve_http

__all__ = ["ClipServer", "serve_http"]
