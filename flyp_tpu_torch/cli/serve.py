"""Serve a (fine-tuned) CLIP checkpoint from the command line, on the GPU.

Counterpart of ``flyp_tpu/cli/serve.py``: builds a
:class:`flyp_tpu_torch.serving.ClipServer` from any ``--clip_load``
artifact (a trainer epoch or step checkpoint directory, a bare
``save_params`` tree, or a torch CLIP ``.pt``) and either classifies
images or dumps features in batch mode, streaming batches through the
pipelined bucketed path, or answers HTTP requests (``--http PORT``,
``serving/http.py``).

Examples::

    python -m flyp_tpu_torch.cli.serve --checkpoint model.pt \\
        --model ViT-B/16 --train-dataset ImageNet --images photos/ \\
        --top-k 5 --output preds.tsv

    python -m flyp_tpu_torch.cli.serve --checkpoint model.pt \\
        --classnames "cat,dog" --images a.png b.png

    python -m flyp_tpu_torch.cli.serve --checkpoint model.pt \\
        --images photos/ --features feats.npz     # no head needed

    python -m flyp_tpu_torch.cli.serve --checkpoint ckpt/checkpoint_4 \\
        --classnames "cat,dog" --warmup --http 8080   # POST /classify, ...
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterator, List, Sequence

import numpy as np

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp", ".tif", ".tiff")


def collect_image_paths(inputs: Sequence[str]) -> List[str]:
    """Expand files and directories (recursive, sorted) into image paths."""
    out: List[str] = []
    for p in inputs:
        if os.path.isdir(p):
            for root, _dirs, files in sorted(os.walk(p)):
                out.extend(os.path.join(root, f) for f in sorted(files) if f.lower().endswith(_IMAGE_EXTS))
        elif os.path.isfile(p):
            out.append(p)
        else:
            raise FileNotFoundError(f"--images entry {p!r} is neither a file nor a directory")
    if not out:
        raise ValueError(f"no images found under {list(inputs)!r}")
    return out


def _rebatch_paths(paths: Sequence[str], batch: int) -> Iterator[List[str]]:
    for i in range(0, len(paths), batch):
        yield list(paths[i : i + batch])


def decoded_batches(paths: Sequence[str], image_size: int, batch: int) -> Iterator[np.ndarray]:
    """Yield [n, H, W, 3] float32 batches through the eval transform; batch
    spans match :func:`_rebatch_paths` for the same (paths, batch)."""
    from PIL import Image

    from flyp_tpu_torch.data.transforms import eval_transform

    tf = eval_transform(image_size)
    for chunk in _rebatch_paths(paths, batch):
        yield np.stack([tf(Image.open(p)) for p in chunk])


def _resolve_classnames(args) -> List[str]:
    if args.classnames:
        return [c.strip() for c in args.classnames.split(",") if c.strip()]
    from types import SimpleNamespace

    from flyp_tpu_torch.data.registry import get_classnames_for

    return get_classnames_for(args.train_dataset, SimpleNamespace(data_location=args.data_location))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", "--clip_load", dest="checkpoint", required=True,
                   help="trainer checkpoint dir (epoch or step), bare param tree, or torch .pt")
    p.add_argument("--model", default="ViT-B/16", help="model config name (default ViT-B/16)")
    p.add_argument("--images", nargs="+", default=None,
                   help="image files and/or directories (batch mode; not used with --http)")
    p.add_argument("--classnames", default=None, help="comma-separated class names")
    p.add_argument("--train-dataset", default=None,
                   help="dataset name whose classnames build the zero-shot head")
    p.add_argument("--template", default=None, help="prompt template set name")
    p.add_argument("--data-location", default=None, help="data root for dataset classname lookup")
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--output", default=None, help="TSV path for predictions (default: stdout)")
    p.add_argument("--features", default=None,
                   help="write an .npz (features, paths) instead of classifying")
    p.add_argument("--image-buckets", default="8,64,256",
                   help="batch buckets requests pad to, ascending (default 8,64,256)")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--warmup", action="store_true", help="run every bucket once before serving")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve over HTTP instead of batch mode (serving/http.py: "
                        "POST /classify, /features, /text_features; GET /healthz)")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="HTTP bind address (default loopback; 0.0.0.0 to expose)")
    return p


_BATCH_ONLY = ("images", "features", "output", "top_k")  # flags that only batch mode reads


def main(argv=None, config_override=None) -> int:
    """``config_override`` (a CLIPConfig) bypasses the named-config lookup,
    for tests serving tiny models."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.http is not None:
        given = [f"--{k.replace('_', '-')}" for k in _BATCH_ONLY if getattr(args, k) != parser.get_default(k)]
        if given:
            raise SystemExit(f"{', '.join(given)} only apply to batch mode; drop them with --http "
                             "(/classify takes ?k= per request)")
    if args.http is None and args.images is None:
        raise SystemExit("batch mode needs --images (or pass --http PORT to serve over HTTP)")
    if args.http is None and args.features is None and not (args.classnames or args.train_dataset):
        raise SystemExit("classification needs --classnames or --train-dataset "
                         "(or pass --features to dump embeddings)")
    if args.top_k < 1:
        raise SystemExit(f"--top-k must be >= 1, got {args.top_k}")

    from flyp_tpu_torch.serving import ClipServer

    buckets = tuple(int(b) for b in args.image_buckets.split(","))
    # A head wherever class names are given, but for a feature dump.  Under
    # --http it is optional: without one /classify gets 400.
    named = args.classnames or args.train_dataset
    classnames = _resolve_classnames(args) if named and args.features is None else None
    template = None
    if classnames is not None and args.template:
        from flyp_tpu_torch.templates import get_template

        template = get_template(args.template)
    srv = ClipServer.from_checkpoint(
        args.checkpoint,
        model=args.model,
        classnames=classnames,
        template=template,
        compute_dtype=args.compute_dtype,
        config_override=config_override,
        device=args.device,
        image_buckets=buckets,
    )
    if args.warmup:
        srv.warmup()

    if args.http is not None:
        from flyp_tpu_torch.serving import serve_http

        httpd = serve_http(srv, args.http, classnames=classnames, host=args.http_host)
        host, port = httpd.server_address[:2]
        print(f"serving on http://{host}:{port} "
              f"(/healthz, /features, /text_features{', /classify' if srv.head is not None else ''})",
              flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
        return 0

    paths = collect_image_paths(args.images)
    batches = decoded_batches(paths, srv.model.config.vision.image_size, buckets[-1])

    if args.features:
        feats = list(srv.stream_features(batches))
        np.savez(args.features, features=np.concatenate(feats), paths=np.array(paths))
        print(f"wrote {len(paths)} features -> {args.features}")
        return 0

    k = min(args.top_k, len(classnames))
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        header = ["path", "pred", "prob"] + [f"top{i + 1}" for i in range(k)]
        print("\t".join(header), file=out)
        for chunk, logits in zip(_rebatch_paths(paths, buckets[-1]), srv.stream_logits(batches)):
            logits = np.asarray(logits, np.float32)
            probs = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs /= probs.sum(axis=1, keepdims=True)
            idx = np.argsort(-probs, axis=1)[:, :k]
            for row, p in enumerate(chunk):
                names = [classnames[j] for j in idx[row]]
                cols = [p, names[0], f"{probs[row, idx[row, 0]]:.6f}"] + names
                print("\t".join(cols), file=out)
    finally:
        if args.output:
            out.close()
            print(f"wrote {len(paths)} predictions -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
