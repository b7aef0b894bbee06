"""ctypes bindings for the port's native decode/transform library.

Counterpart of ``flyp_tpu/data/native_decode.py``.  ``native/flyp_native.cc``
(the port's own copy of the JAX package's source) decodes JPEG and PNG and
runs the CLIP bicubic transforms with Pillow-matching numerics.  ctypes
releases the GIL for each call, so the threaded loader
(``flyp_tpu_torch/data/loader.py``) scales across host cores.

The library is built with ``g++`` at first use into
``build/flyp_tpu_torch_host/``, under a name keyed by the source and flags,
written to a temporary name first (as ``ops/_kernels.py`` builds the CUDA
kernels).  The flags leave out ``-march=native`` and ``-ffast-math`` and
turn off FMA contraction, so every host computes the same bits, and the
same bits as the JAX package's build on x86.

Codecs: the build probes for each codec's header and compiles in those it
finds (``codecs()`` says which): JPEG with libjpeg (``jpeglib.h``), PNG with
the source's own reader on zlib (``zlib.h``).  The NVIDIA H100 machine has
zlib but not libjpeg (nor libpng), so there PNG decodes natively and JPEG
raises :class:`CodecUnavailable`, which :class:`NativeTransform` answers
with Pillow where it is installed, as the JAX package answers formats its
library lacks.

Unlike the JAX module, a library that fails to build raises
:class:`NativeCompileError` with the compiler's message: ``available()`` is
False then, but ``get_csv_loader(data_backend="native")`` raises rather
than quietly running the Pillow transforms.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from flyp_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, sample_resized_crop_box

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "flyp_native.cc"
BUILD_DIR = _PKG.parent / "build" / "flyp_tpu_torch_host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
# codec -> (header probed for, macro, link flag), in flyp_codecs()'s bit order.
CODECS = {"jpeg": ("jpeglib.h", "FLYP_HAVE_JPEG", "-ljpeg"), "png": ("zlib.h", "FLYP_HAVE_PNG", "-lz")}
_NO_CODEC = -2


class NativeCompileError(RuntimeError):
    """``g++`` could not build the library; the message carries its output."""


class CodecUnavailable(ValueError):
    """A JPEG or PNG file whose codec this build of the library lacks."""


def _has_header(header: str) -> bool:
    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
                              capture_output=True, text=True, timeout=60)
    except OSError:  # no g++: build() says so
        return False
    return proc.returncode == 0


def probe_codecs() -> Tuple[str, ...]:
    """The codecs whose headers this host's ``g++`` finds."""
    return tuple(name for name, (header, _, _) in CODECS.items() if _has_header(header))


def build() -> Path:
    """Compile the library with the codecs :func:`probe_codecs` finds,
    unless a library of this source and these flags exists."""
    codecs = probe_codecs()
    defines = [f"-D{CODECS[c][1]}" for c in codecs]
    libs = [CODECS[c][2] for c in codecs]
    flags = (*CXX_FLAGS, *defines)
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags + tuple(libs)).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libflyp_native_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(SOURCE), *libs, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise NativeCompileError(f"cannot run g++ to build {SOURCE.name}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeCompileError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def bind(path: Path) -> ctypes.CDLL:
    """Open a built library and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    lib.flyp_codecs.argtypes = []
    lib.flyp_codecs.restype = ctypes.c_int
    lib.flyp_image_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.flyp_image_info.restype = ctypes.c_int
    lib.flyp_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.flyp_decode_rgb.restype = ctypes.c_int
    lib.flyp_transform.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.flyp_transform.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The library, built on first use; raises :class:`NativeCompileError`."""
    return bind(build())


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        load()
    except (NativeCompileError, OSError):
        return False
    return True


def codecs() -> Dict[str, bool]:
    """Which codecs the loaded library decodes."""
    bits = load().flyp_codecs()
    return {name: bool(bits >> i & 1) for i, name in enumerate(CODECS)}


def _codec_error(data: bytes) -> CodecUnavailable:
    name = "JPEG" if data[:3] == b"\xff\xd8\xff" else "PNG"
    header = CODECS[name.lower()][0]
    return CodecUnavailable(f"{name}: the native library was built without this codec ({header} was not found "
                            "when it was compiled)")


def decode(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> RGB8 HWC array.  Raises ValueError on failure,
    :class:`CodecUnavailable` for a codec this build lacks."""
    lib = load()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.flyp_image_info(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc == _NO_CODEC:
        raise _codec_error(data)
    if rc != 0:
        raise ValueError("unsupported or corrupt image")
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    if lib.flyp_decode_rgb(data, len(data), out.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise ValueError("image decode failed")
    return out


_MEAN = np.ascontiguousarray(CLIP_MEAN, dtype=np.float32)
_STD = np.ascontiguousarray(CLIP_STD, dtype=np.float32)


def _transform(rgb: np.ndarray, box: Tuple[float, float, float, float],
               rs_w: int, rs_h: int, crop: Tuple[int, int, int]) -> np.ndarray:
    lib = load()
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"the native transform takes uint8 [H, W, 3] RGB, got {rgb.dtype} {list(rgb.shape)}")
    h, w = rgb.shape[:2]
    cx, cy, cs = crop
    out_size = cs if cs > 0 else None
    out = np.empty((out_size or rs_h, out_size or rs_w, 3), dtype=np.float32)
    rgb = np.ascontiguousarray(rgb)
    rc = lib.flyp_transform(
        rgb.ctypes.data_as(ctypes.c_void_p), h, w,
        box[0], box[1], box[2], box[3], rs_w, rs_h, cx, cy, cs,
        _MEAN.ctypes.data_as(ctypes.c_void_p), _STD.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise ValueError("native transform failed")
    return out


def train_transform_from_rgb(rgb: np.ndarray, n_px: int, rng: np.random.Generator) -> np.ndarray:
    """RandomResizedCrop(0.9-1.0 bicubic) + normalize, PIL-equivalent."""
    h, w = rgb.shape[:2]
    top, left, ch, cw = sample_resized_crop_box(w, h, rng)
    return _transform(rgb, (left, top, left + cw, top + ch), n_px, n_px, (0, 0, 0))


def eval_transform_from_rgb(rgb: np.ndarray, n_px: int) -> np.ndarray:
    """Resize shortest side + center crop + normalize, PIL-equivalent."""
    h, w = rgb.shape[:2]
    if w <= h:
        new_w, new_h = n_px, max(1, round(n_px * h / w))
    else:
        new_w, new_h = max(1, round(n_px * w / h)), n_px
    left = round((new_w - n_px) / 2)
    top = round((new_h - n_px) / 2)
    return _transform(rgb, (0, 0, w, h), new_w, new_h, (left, top, n_px))


def _as_rgb(arr: np.ndarray) -> np.ndarray:
    """uint8 gray ``[H, W]``, RGB or RGBA -> RGB: what ``Image.fromarray``
    then ``convert("RGB")`` gives (gray replicated, alpha dropped)."""
    if arr.ndim == 2:
        return np.repeat(arr[:, :, None], 3, axis=2)
    if arr.ndim == 3 and arr.shape[2] in (3, 4):
        return arr[:, :, :3]
    raise ValueError(f"an image array must be [H, W], [H, W, 3] or [H, W, 4], got {list(arr.shape)}")


class NativeTransform:
    """Path-consuming transform: native decode + transform, Pillow for the
    formats the library does not decode.

    Datasets detect the ``from_path`` attribute and hand over the file path
    instead of a decoded PIL image, keeping the whole hot path in C++; they
    hand decoded arrays (``.npy`` files) to ``from_rgb``.
    """

    def __init__(self, n_px: int, train: bool):
        self.n_px = n_px
        self.train = train

    def from_path(self, path: str, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        with open(path, "rb") as f:
            return self.from_bytes(f.read(), rng)

    def from_bytes(self, data: bytes, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        try:
            rgb = decode(data)
        except ValueError as exc:  # a format the library does not decode: Pillow decodes, C++ transforms
            try:
                from PIL import Image
            except ImportError:
                raise exc from None
            import io

            img = Image.open(io.BytesIO(data))
            rgb = np.asarray(img.convert("RGB") if img.mode != "RGB" else img)
        return self.from_rgb(rgb, rng)

    def from_rgb(self, rgb: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """uint8 RGB ``[H, W, 3]`` (or gray/RGBA, converted as Pillow does)
        in, the transform out: the ``.npy`` branch's entry, which the JAX
        package reaches through ``Image.fromarray``."""
        rgb = _as_rgb(rgb)
        if self.train:
            return train_transform_from_rgb(rgb, self.n_px, rng or np.random.default_rng())
        return eval_transform_from_rgb(rgb, self.n_px)

    def __call__(self, img, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """PIL-image entry point (same signature as the Python transforms)."""
        return self.from_rgb(np.asarray(img.convert("RGB") if img.mode != "RGB" else img), rng)


def native_train_transform(n_px: int) -> NativeTransform:
    load()  # a library that does not build raises here, naming the compiler's message
    return NativeTransform(n_px, train=True)


def native_eval_transform(n_px: int) -> NativeTransform:
    load()
    return NativeTransform(n_px, train=False)
