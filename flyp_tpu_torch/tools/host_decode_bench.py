"""Host input path: native C++ decode and transform against Pillow, per
core.

Counterpart of ``tools/host_decode_bench.py``.  Per image, on one thread:
the decode + transform cost (us/image) of JPEG and PNG sources through the
train (RandomResizedCrop) and eval (resize + center crop) transforms, on
the native path (``native/flyp_native.cc`` through
``data/native_decode.py``, the GIL released) and on Pillow's
(``data/transforms.py``, the reference's worker path); images/s a core for
each; and the host cores one card needs to feed training at the train-JPEG
rate.  Where the native library was built without a codec (no ``jpeglib.h``
on the machine), ``NativeTransform`` decodes that format with Pillow and
transforms natively, as the loader does, and the codec line says so.

``CHIP_RATES`` are the card's measured training rates (img/s, PERF.md §5:
``chip_smoke.py`` on one NVIDIA H100 80GB HBM3 at 700 W, ViT-B/16 in PR 8,
RN50 in PR 12); a caller may pass the rates its own run measured.

Usage: python -m flyp_tpu_torch.tools.host_decode_bench [n_images] [px]
"""

from __future__ import annotations

import argparse
import io
import json
import time

import numpy as np

CHIP_RATES = {"ViT-B/16 bs256": 1321.19, "RN50 bs256": 2009.80}


def make_images(n: int, src_px: int = 480):
    """Synthetic photos (noise on smooth gradients, so JPEG's entropy is
    realistic) as JPEG and PNG bytes."""
    from PIL import Image

    rng = np.random.default_rng(0)
    jpegs, pngs = [], []
    for _ in range(n):
        y, x = np.mgrid[0:src_px, 0:src_px]
        base = (128 + 60 * np.sin(x / 17.0) * np.cos(y / 23.0)).astype(np.uint8)
        arr = np.stack([base, np.roll(base, 7, 0), np.roll(base, 13, 1)], -1)
        arr = np.clip(arr.astype(np.int16) + rng.integers(-25, 25, arr.shape), 0, 255).astype(np.uint8)
        img = Image.fromarray(arr)
        for fmt, out in (("JPEG", jpegs), ("PNG", pngs)):
            buf = io.BytesIO()
            img.save(buf, format=fmt, quality=90)
            out.append(buf.getvalue())
    return jpegs, pngs


def time_path(fn, payloads, iters: int) -> float:
    """Mean us/image over ``iters`` passes of the payload list (host clock:
    the work is on the host)."""
    fn(payloads[0])  # warm caches and the library's first load
    t0 = time.perf_counter()
    for _ in range(iters):
        for p in payloads:
            fn(p)
    return (time.perf_counter() - t0) / (iters * len(payloads)) * 1e6


def main(n_images: int = 32, px: int = 224, iters: int = 4, chip_rates=None) -> dict:
    from PIL import Image

    from flyp_tpu_torch.data import native_decode
    from flyp_tpu_torch.data.transforms import eval_transform, train_transform

    if not native_decode.available():
        raise RuntimeError("the native library failed to build")
    chip_rates = chip_rates or CHIP_RATES
    jpegs, pngs = make_images(n_images)
    print(f"{n_images} synthetic 480px images; JPEG ~{len(jpegs[0]) // 1024}KB, "
          f"PNG ~{len(pngs[0]) // 1024}KB; target {px}px", flush=True)
    print(f"native codecs: {native_decode.codecs()} (a format without one decodes in Pillow, then transforms "
          "natively)", flush=True)

    rng = np.random.default_rng(1)
    nat_train = native_decode.NativeTransform(px, train=True)
    nat_eval = native_decode.NativeTransform(px, train=False)
    pil_train = train_transform(px)
    pil_eval = eval_transform(px)

    def pil_path(transform):
        def run(data):
            img = Image.open(io.BytesIO(data))
            return transform(img.convert("RGB") if img.mode != "RGB" else img, rng)
        return run

    rows = {}
    for fmt, payloads in (("jpeg", jpegs), ("png", pngs)):
        rows[f"native_train_{fmt}"] = time_path(lambda d: nat_train.from_bytes(d, rng), payloads, iters)
        rows[f"native_eval_{fmt}"] = time_path(nat_eval.from_bytes, payloads, iters)
        rows[f"pil_train_{fmt}"] = time_path(pil_path(pil_train), payloads, iters)
        rows[f"pil_eval_{fmt}"] = time_path(pil_path(pil_eval), payloads, iters)

    print(f"\n{'path':24s} {'us/img':>9s} {'img/s/core':>11s}")
    for k, us in rows.items():
        print(f"{k:24s} {us:9.0f} {1e6 / us:11.1f}")

    nat_rate = 1e6 / rows["native_train_jpeg"]
    pil_rate = 1e6 / rows["pil_train_jpeg"]
    print(f"\nnative/PIL speedup (train jpeg): {nat_rate / pil_rate:.2f}x")
    print("host cores per chip to feed training (train-jpeg path):")
    cores = {}
    for name, rate in chip_rates.items():
        cores[name] = {"native": rate / nat_rate, "pil": rate / pil_rate}
        print(f"  {name:16s}: native {cores[name]['native']:5.1f} cores   PIL {cores[name]['pil']:5.1f} cores")

    result = {
        "metric": "host decode+transform us/image (1 core)",
        "us_per_image": {k: round(v, 1) for k, v in rows.items()},
        "img_per_s_per_core": {k: round(1e6 / v, 1) for k, v in rows.items()},
        "native_over_pil_train_jpeg": round(nat_rate / pil_rate, 3),
        "cores_per_chip": {k: {kk: round(vv, 2) for kk, vv in v.items()} for k, v in cores.items()},
    }
    print(json.dumps(result), flush=True)
    return result


def cli(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", nargs="*", type=int, metavar="[n_images] [px]")
    args = parser.parse_args(argv)
    return main(*args.sizes[:2])


if __name__ == "__main__":
    cli()
