"""Minimal stdlib HTTP front-end for :class:`flyp_tpu_torch.serving.ClipServer`.

Counterpart of ``flyp_tpu/serving/http.py``: the same endpoints, bodies,
status codes and JSON keys, so a client of the JAX server talks to this one
unchanged.

* ``http.server.ThreadingHTTPServer``: one thread per request.  That is
  safe because ``ClipServer``'s request methods are reentrant: each call
  owns its buffers, and ``models/modes.py::pinned_mode`` serialises the
  mode flips of the shared model (concurrent requests get exactly what
  sequential ones would).
* Image payloads are ``.npy`` bodies (``Content-Type: application/x-npy``)
  or JSON ``{"images": [...]}`` nested lists; responses are JSON, float32
  values through ``tolist()``.

Endpoints::

    GET  /healthz            -> {"ok": true, "model": ..., "buckets": [...],
                                 "num_classes": N | null}
    POST /features           -> {"features": [[...], ...]}      (images)
    POST /text_features      -> {"features": [[...], ...]}      (json {"texts": [...]})
    POST /classify?k=5       -> {"probs": [[...]], "indices": [[...]],
                                 "classes": [[name, ...], ...]}  (images; needs a head)

Status codes: 404 on an unknown path; 400 with ``{"error": "Type:
message"}`` when the request is at fault (a malformed body, bad JSON, a
missing key, an image array of the wrong rank, channels or size, checked
here before the model runs) and on ``/classify`` without a head; 500 with
a generic message when the server fails on a well-formed request (its
traceback goes to stderr).  The JAX server answers every failure with 400.

Run via ``python -m flyp_tpu_torch.cli.serve --http PORT ...``.
"""

from __future__ import annotations

import io
import json
import sys
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

_POST_PATHS = ("/features", "/text_features", "/classify")
# What parsing a request's body can raise; each means the request is at fault.
_CLIENT_ERRORS = (ValueError, KeyError, TypeError, EOFError)


def _decode_images(body: bytes, content_type: str, image_size: int) -> np.ndarray:
    if "json" in (content_type or ""):
        payload = json.loads(body.decode("utf-8"))
        images = np.asarray(payload["images"], np.float32)
    else:
        images = np.load(io.BytesIO(body), allow_pickle=False)
    if not (np.issubdtype(images.dtype, np.number) or images.dtype == np.bool_):
        raise TypeError(f"images must be numeric, got dtype {images.dtype}")
    want = (image_size, image_size, 3)
    if images.ndim != 4 or images.shape[1:] != want or images.shape[0] == 0:
        raise ValueError(f"images must be [n >= 1, {image_size}, {image_size}, 3], got shape {list(images.shape)}")
    return images


def _decode_texts(body: bytes) -> list:
    texts = json.loads(body.decode("utf-8"))["texts"]
    if not isinstance(texts, list) or not texts or not all(isinstance(t, str) for t in texts):
        raise TypeError("texts must be a non-empty list of strings")
    return texts


def make_handler(server, classnames: Optional[Sequence[str]] = None):
    """Request handler class bound to one ClipServer instance."""
    image_size = server.model.config.vision.image_size

    class ClipHandler(BaseHTTPRequestHandler):
        # Quiet by default: per-request stderr lines would swamp a
        # throughput deployment.
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if urlparse(self.path).path != "/healthz":
                return self._reply(404, {"error": f"unknown path {self.path!r}"})
            self._reply(
                200,
                {
                    "ok": True,
                    "model": type(server.model).__name__,
                    "buckets": list(server.image_buckets),
                    "num_classes": None if server.head is None else int(server.head.weight.shape[0]),
                },
            )

        def _parse(self, path: str, query: str):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            ctype = self.headers.get("Content-Type", "")
            if path == "/text_features":
                return _decode_texts(body), None
            k = None
            if path == "/classify":
                k = int(parse_qs(query).get("k", ["5"])[0])
                if k < 1:
                    raise ValueError(f"k must be >= 1, got {k}")
            return _decode_images(body, ctype, image_size), k

        def do_POST(self):  # noqa: N802
            parsed = urlparse(self.path)
            if parsed.path not in _POST_PATHS:
                return self._reply(404, {"error": f"unknown path {parsed.path!r}"})
            if parsed.path == "/classify" and server.head is None:
                return self._reply(400, {"error": "server has no classification head"})
            try:
                inputs, k = self._parse(parsed.path, parsed.query)
            except _CLIENT_ERRORS as e:
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            try:
                if parsed.path == "/features":
                    out = {"features": np.asarray(server.encode_images(inputs), np.float32).tolist()}
                elif parsed.path == "/text_features":
                    out = {"features": np.asarray(server.encode_texts(inputs), np.float32).tolist()}
                else:
                    probs, idx = server.top_k(inputs, k=k)
                    out = {"probs": probs.tolist(), "indices": idx.tolist()}
                    if classnames is not None:
                        out["classes"] = [[classnames[j] for j in row] for row in idx]
            except Exception:  # the request was well-formed: the server is at fault
                traceback.print_exc(file=sys.stderr)
                return self._reply(500, {"error": "internal server error"})
            return self._reply(200, out)

    return ClipHandler


def serve_http(
    server, port: int, classnames: Optional[Sequence[str]] = None, host: str = "127.0.0.1"
) -> ThreadingHTTPServer:
    """Bind a :class:`ThreadingHTTPServer` for ``server``; the caller owns
    the loop (``serve_forever()``) and shutdown.  ``port=0`` binds an
    ephemeral port; the bound port is ``.server_address[1]``."""
    return ThreadingHTTPServer((host, port), make_handler(server, classnames))
