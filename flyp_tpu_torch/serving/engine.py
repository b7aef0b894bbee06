"""Serving front-end for (fine-tuned) CLIP models on one GPU.

Counterpart of ``flyp_tpu/serving/engine.py``.  ``ClipServer`` packages:

* **Batch buckets**: a request pads to the smallest batch bucket; an
  oversize request splits into max-bucket chunks plus a bucketed tail, and
  at most ``window`` chunks are in flight, so host<->device copies overlap
  device work while live device buffers stay bounded.
* **Text width bucketing**: captions tokenize to the context length and
  are sliced to the batch's bucketed max-EOT width (``shrink_context``),
  which is exact for the causal tower with EOT pooling.
* **Host casts**: float images are cast to bf16 on the host when the model
  computes in bf16, then copied from pinned memory without blocking.
* **Pipelined streams**: ``stream_logits``/``stream_features`` keep one
  batch in flight (``utils.pipeline.OneStepLag``).

Every transformer block runs the attention-block CUDA kernel
(``ops/attention_block.py``): both towers of a ViT CLIP, the text tower of a
ModifiedResNet one (whose image tower runs cuDNN convolutions and BatchNorm
on its running statistics); requests run under ``torch.inference_mode()``
and in eval mode whatever the model's mode (the JAX package's
``train=False``), which is restored after each dispatch.  Request methods
are reentrant: concurrent callers (``serving/http.py``'s threads) get
exactly the results of sequential calls (``models/modes.py``).
Measured rates on the H100 are in PERF.md.

Under a profiler each request records spans (``utils/profiling.py::span``)
that share its id: the root ``serve.request`` (its rows) and, inside it,
``serve.cast``, then per chunk ``serve.pad``, ``serve.h2d``,
``serve.lock_wait`` (the wait for the mode lock), ``serve.forward`` (the
launch under the lock, with its bucket, timed on the device's stream) and
``serve.d2h``.  A streamed batch is a request of its own.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.head import ClassificationHead
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.tokenizer import shrink_context, tokenize
from flyp_tpu_torch.utils.pipeline import OneStepLag, host_cast_images, to_device
from flyp_tpu_torch.utils.profiling import span


class ClipServer:
    """Bucketed, pipelined CLIP inference on one device.

    ``image_buckets`` are the batch sizes requests pad to (ascending); a
    request of n rows pads to the smallest bucket >= n, and n > max(buckets)
    splits into max-bucket chunks + a bucketed tail.  ``head`` (optional)
    enables :meth:`classify`; build one from classnames with
    :meth:`for_classification`.  Features are L2-normalised (``normalize=
    False`` for raw tower outputs).  Results come back as float32 numpy
    arrays.
    """

    def __init__(
        self,
        model: CLIPModel,
        head: Optional[ClassificationHead] = None,
        image_buckets: Sequence[int] = (8, 64, 256),
        normalize: bool = True,
        window: int = 4,
    ):
        if not image_buckets or list(image_buckets) != sorted(set(image_buckets)):
            raise ValueError(f"image_buckets must be ascending and unique, got {image_buckets!r}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.model = model
        self.head = head
        self.image_buckets = tuple(int(b) for b in image_buckets)
        self.normalize = normalize
        self.window = int(window)

    @classmethod
    def for_classification(cls, model: CLIPModel, classnames: Sequence[str], template, **kwargs) -> "ClipServer":
        """Server with a zero-shot head built from the model's own text tower
        (mean-of-templates class embeddings, evaluation/zeroshot.py)."""
        from flyp_tpu_torch.evaluation.zeroshot import get_zeroshot_classifier

        head = get_zeroshot_classifier(model, classnames, template)
        return cls(model, head=head, **kwargs)

    @classmethod
    def from_checkpoint(
        cls,
        path: Optional[str],
        model: str = "ViT-B/16",
        classnames: Optional[Sequence[str]] = None,
        template=None,
        compute_dtype: str = "bfloat16",
        config_override=None,
        device="cuda",
        seed: int = 0,
        **kwargs,
    ) -> "ClipServer":
        """One call from a training artifact to a running server.

        ``path`` takes everything ``--clip_load`` does
        (``models/factory.py::build_clip_model``): a trainer
        ``checkpoint_{e}`` / ``checkpoint_{e}_step_{i}`` directory of
        ``utils/checkpoint.py`` (its moments and cursors are not read; a
        ModifiedResNet's running statistics are), a bare ``save_params``
        tree (refused for a ModifiedResNet, which would lack its running
        statistics), or a torch CLIP ``.pt``/``.bin`` (OpenAI key layout, as
        the JAX package's converter writes it); or None for
        CLIP-initialised random weights drawn from ``seed``.  Pass
        ``classnames`` (and ``template``, default the simple template) to
        build the zero-shot head.  ``device`` defaults to the GPU and raises
        if CUDA is absent; ``compute_dtype="float32"`` gives CPU parity with
        fp32 evaluators.
        """
        from types import SimpleNamespace

        from flyp_tpu_torch.models.factory import build_clip_model

        cfg = SimpleNamespace(model=model, clip_load=path, compute_dtype=compute_dtype, seed=seed)
        clip_model = build_clip_model(cfg, config_override=config_override, device=device)
        if classnames is not None:
            if template is None:
                from flyp_tpu_torch.templates import simple_template

                template = simple_template
            return cls.for_classification(clip_model, classnames, template, **kwargs)
        return cls(clip_model, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.model.device

    # -- bucketing -----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.image_buckets:
            if n <= b:
                return b
        return self.image_buckets[-1]

    def _chunks(self, n: int) -> list:
        """(start, count, bucket) spans covering n rows."""
        out, start, bmax = [], 0, self.image_buckets[-1]
        while n - start > bmax:
            out.append((start, bmax, bmax))
            start += bmax
        out.append((start, n - start, self.bucket_for(n - start)))
        return out

    @staticmethod
    def _pad_rows(t: torch.Tensor, bucket: int) -> torch.Tensor:
        if t.shape[0] == bucket:
            return t
        pad = torch.zeros((bucket - t.shape[0], *t.shape[1:]), dtype=t.dtype)
        return torch.cat([t, pad])

    def _prep_images(self, images) -> torch.Tensor:
        with span("serve.cast"):
            return host_cast_images(images, self.model.compute_dtype)

    def _upload(self, host: torch.Tensor, bucket: int) -> torch.Tensor:
        """A chunk padded to ``bucket`` rows and on its way to the device."""
        with span("serve.pad", rows=host.shape[0], bucket=bucket):
            host = self._pad_rows(host, bucket)
        with span("serve.h2d"):
            return to_device(host, self.device)

    @staticmethod
    def _fetch(handle: torch.Tensor, rows: int, root=None) -> torch.Tensor:
        """A chunk's first ``rows`` results on the host, as float32."""
        with span("serve.d2h", root=root, rows=rows):
            return handle[:rows].float().cpu()

    def _run_chunks(self, host: torch.Tensor, dispatch) -> np.ndarray:
        """Dispatch bucket-padded chunks with at most ``window`` in flight."""
        out: list = []
        pending: collections.deque = collections.deque()
        for s, c, b in self._chunks(host.shape[0]):
            pending.append((dispatch(self._upload(host[s : s + c], b)), c))
            if len(pending) > self.window:
                out.append(self._fetch(*pending.popleft()))
        while pending:
            out.append(self._fetch(*pending.popleft()))
        return torch.cat(out).numpy()

    @contextlib.contextmanager
    def _forward(self, x: torch.Tensor):
        """One forward's eval-mode pin, its wait for the pin's lock and its
        launch under it as spans."""
        with pinned_mode(self.model, train=False, wait_span="serve.lock_wait"), \
                span("serve.forward", stream_of=x, bucket=len(x)):
            yield

    def _img_fn(self, x: torch.Tensor) -> torch.Tensor:
        with self._forward(x):
            return self.model.encode_image(x, normalize=self.normalize)

    def _txt_fn(self, t: torch.Tensor) -> torch.Tensor:
        with self._forward(t):
            return self.model.encode_text(t, normalize=self.normalize)

    def _logits_fn(self, x: torch.Tensor) -> torch.Tensor:
        # Raw tower features: the zero-shot head normalises internally, and
        # normalising here too would drift from the evaluator's numbers.
        with self._forward(x):
            return self.head(self.model.encode_image(x))

    # -- request APIs ---------------------------------------------------------

    def _serve(self, request, prepare, dispatch) -> np.ndarray:
        """One request under its root span: ``prepare(request)`` gives its
        host rows, which run through ``dispatch``."""
        with span("serve.request") as root:
            host = prepare(request)
            if root is not None:
                root.attrs["rows"] = host.shape[0]
            return self._run_chunks(host, dispatch)

    @staticmethod
    def _tokens(texts) -> torch.Tensor:
        tokens = tokenize(list(texts)) if not isinstance(texts, np.ndarray) else texts
        return torch.from_numpy(np.ascontiguousarray(shrink_context(np.asarray(tokens))))

    @torch.inference_mode()
    def encode_images(self, images) -> np.ndarray:
        """[n, H, W, C] host array -> [n, D] features (any n)."""
        return self._serve(images, self._prep_images, self._img_fn)

    @torch.inference_mode()
    def encode_texts(self, texts) -> np.ndarray:
        """Captions (list of str, or a pre-tokenized [n, ctx] int array) ->
        [n, D] features.  Width is sliced to the bucketed max EOT (exact)."""
        return self._serve(texts, self._tokens, self._txt_fn)

    @torch.inference_mode()
    def classify(self, images) -> np.ndarray:
        """[n, H, W, C] -> [n, num_classes] zero-shot logits (fp32)."""
        if self.head is None:
            raise ValueError("classify() needs a head; use for_classification(...) or pass head=")
        return self._serve(images, self._prep_images, self._logits_fn)

    def top_k(self, images, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """(probs [n, k], class indices [n, k]), descending.  ``k`` clamps
        to the number of classes."""
        logits = self.classify(images).astype(np.float32)
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        k = min(int(k), probs.shape[1])
        idx = np.argpartition(-probs, min(k, probs.shape[1] - 1), axis=1)[:, :k]
        order = np.take_along_axis(probs, idx, axis=1).argsort(axis=1)[:, ::-1]
        idx = np.take_along_axis(idx, order, axis=1)
        return np.take_along_axis(probs, idx, axis=1), idx

    def similarity(self, image_features: np.ndarray, text_features: np.ndarray) -> np.ndarray:
        """[n, D] x [m, D] -> [n, m] cosine similarities scaled by the
        learned temperature.  Features must come from this server
        (normalised)."""
        scale = float(np.exp(self.model.logit_scale.detach().float().cpu().numpy()))
        return scale * np.asarray(image_features, np.float32) @ np.asarray(text_features, np.float32).T

    # -- throughput mode ------------------------------------------------------

    @torch.inference_mode()
    def _stream(self, batches: Iterable, dispatch) -> Iterator[np.ndarray]:
        lag = OneStepLag()
        for batch in batches:
            with span("serve.request") as request:
                host = self._prep_images(batch)
                n = host.shape[0]
                if request is not None:
                    request.attrs["rows"] = n
                if n > self.image_buckets[-1]:
                    raise ValueError(f"stream batches must fit the largest bucket ({self.image_buckets[-1]}); got {n}")
                handle = dispatch(self._upload(host, self.bucket_for(n)))
            prev = lag.push((handle, n, None if request is None else request.root))
            if prev is not None:
                yield self._fetch(*prev).numpy()
        prev = lag.flush()
        if prev is not None:
            yield self._fetch(*prev).numpy()

    def stream_features(self, batches: Iterable) -> Iterator[np.ndarray]:
        """Pipelined :meth:`encode_images` over an iterator of batches: one
        batch always in flight, results yielded in order."""
        return self._stream(batches, self._img_fn)

    def stream_logits(self, batches: Iterable) -> Iterator[np.ndarray]:
        if self.head is None:
            raise ValueError("stream_logits() needs a head")
        return self._stream(batches, self._logits_fn)

    # -- warmup ---------------------------------------------------------------

    @torch.inference_mode()
    def warmup(self, text_widths: Sequence[int] = (16, 32)) -> int:
        """Run every serving shape once before the first request (kernel
        build and load, library handles, allocator pools): all image buckets
        (features, and logits when a head is set) and the (batch bucket x
        text width) grid.  Returns the number of shapes run."""
        cfg = self.model.config
        px, ctx = cfg.vision.image_size, cfg.text.context_length
        count = 0
        for b in self.image_buckets:
            images = to_device(host_cast_images(np.zeros((b, px, px, 3), np.float32), self.model.compute_dtype),
                               self.device)
            self._img_fn(images)
            count += 1
            if self.head is not None:
                self._logits_fn(images)
                count += 1
        for w in text_widths:
            for b in self.image_buckets:  # text batches bucket the same way
                tokens = torch.zeros((b, min(int(w), ctx)), dtype=torch.int32)
                tokens[:, 0] = 1  # a nonzero EOT so pooling indexes sanely
                self._txt_fn(to_device(tokens, self.device))
                count += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return count
