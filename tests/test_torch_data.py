"""The port's training input pipeline against the JAX package's, on the CPU.

The same seeded corpus (PNG in several modes, the committed JPEG fixtures,
uint8 and float ``.npy``) goes through ``flyp_tpu.data`` and
``flyp_tpu_torch.data``; batches must be bit-equal: images, tokens,
labels, paths, guidance, img_id and ``tokens_multi``.  Each backend is run
on both sides: ``threads`` (Pillow transforms) against ``threads``, and
``native`` (the C++ library) against ``native``.

The JPEG fixtures under ``tests/fixtures/torch_data/`` were made once with
Pillow 12.1, so that a machine without an encoder can decode JPEG::

    def photo(h, w, seed):
        r = np.random.default_rng(seed)
        y, x = np.mgrid[0:h, 0:w]
        base = np.stack([x * 255 / w, y * 255 / h, (x + y) % 256], axis=-1)
        return (base + r.integers(0, 40, base.shape)).clip(0, 255).astype(np.uint8)
    Image.fromarray(photo(96, 128, 1)).save("rgb420_q90.jpg", quality=90)
    Image.fromarray(photo(75, 100, 2)).save("rgb444_q75.jpg", quality=75, subsampling=0)
    Image.fromarray(photo(80, 64, 3)[:, :, 0]).save("gray_q85.jpg", quality=85)
    Image.fromarray(photo(64, 96, 4)).save("progressive_q80.jpg", quality=80, progressive=True)
"""

import io
import json
import os
import pathlib
import struct
import subprocess
import sys
import zlib

import ml_dtypes
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from flyp_tpu.config import ExperimentConfig as JaxConfig
from flyp_tpu.data import csv_data as jax_csv_data
from flyp_tpu.data import csv_dataset as jax_csv_dataset
from flyp_tpu.data import loader as jax_loader
from flyp_tpu.data import native_decode as jax_nd
from flyp_tpu.data import transforms as jax_transforms
from flyp_tpu_torch.config import ExperimentConfig
from flyp_tpu_torch.data import csv_data, csv_dataset, loader, native_decode as nd, transforms

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_data"
JPEGS = sorted(str(p) for p in FIXTURES.glob("*.jpg"))


@pytest.fixture(scope="module", autouse=True)
def jax_native_library(tmp_path_factory):
    """The JAX package's library, built by its own ``_build`` into this
    module's temporary directory: other test processes build the shared
    copy beside its source at the same time."""
    saved = jax_nd._LIB, jax_nd._lib, jax_nd._failed
    jax_nd._LIB = str(tmp_path_factory.mktemp("jax_native") / "libflyp_native.so")
    jax_nd._lib, jax_nd._failed = None, False
    assert jax_nd.available()
    yield
    jax_nd._LIB, jax_nd._lib, jax_nd._failed = saved


def photo(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / w, y * 255 / h, (x + y) % 256, 255 - x * 255 / w][:channels], axis=-1)
    return (base + rng.integers(0, 40, base.shape)).clip(0, 255).astype(np.uint8)


def png_bytes(arr, color, depth=8, interlace=False, palette=None):
    """A PNG written here: every row filter (0-4) in turn, Adam7 if asked."""
    h, w = arr.shape[:2]
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bpp = max(1, chans * depth // 8)

    def pack(rows):
        if depth == 16:
            return rows.astype(">u2").reshape(rows.shape[0], -1).view(np.uint8)
        flat = rows.reshape(rows.shape[0], -1).astype(np.uint8)
        if depth == 8:
            return flat
        per = 8 // depth
        padded = np.zeros((flat.shape[0], -(-flat.shape[1] // per) * per), np.uint8)
        padded[:, :flat.shape[1]] = flat
        groups = padded.reshape(flat.shape[0], -1, per)
        shifts = np.array([8 - depth * (k + 1) for k in range(per)], np.uint8)
        return (groups << shifts).sum(axis=2).astype(np.uint8)

    def filtered(sub):
        rows, out, prev = pack(sub), bytearray(), None
        for y, row in enumerate(rows.astype(np.int32)):
            f = y % 5
            up = prev if prev is not None else np.zeros_like(row)
            left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
            if f == 0:
                pred = np.zeros_like(row)
            elif f == 1:
                pred = left
            elif f == 2:
                pred = up
            elif f == 3:
                pred = (left + up) // 2
            else:
                p = left + up - upleft
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
            out += bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes()
            prev = row
        return bytes(out)

    if interlace:
        data = b"".join(filtered(arr[y0::dy, x0::dx]) for x0, y0, dx, dy in
                        ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                         (0, 1, 1, 2)) if arr[y0::dy, x0::dx].size)
    else:
        data = filtered(arr)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    plte = chunk(b"PLTE", palette.tobytes()) if palette is not None else b""
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + plte + chunk(b"IDAT", zlib.compress(data))
            + chunk(b"IEND", b""))


def png_cases():
    """(name, bytes) of PNGs in every color type and bit depth."""
    rgb, rgba, gray = photo(23, 31, 1), photo(19, 26, 2, channels=4), photo(21, 17, 3)[:, :, 0]
    cases = {}
    for mode, arr in (("RGB", rgb), ("RGBA", rgba), ("L", gray), ("LA", rgba[:, :, 1:3])):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "PNG")
        cases[f"pil-{mode}"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=13).save(buf, "PNG", transparency=0)
    cases["pil-P-tRNS"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(gray > 128).save(buf, "PNG")
    cases["pil-1bit"] = buf.getvalue()
    wide = np.random.default_rng(4).integers(0, 65536, (13, 11, 3)).astype(np.uint16)
    for interlace in (False, True):
        tag = "-adam7" if interlace else ""
        cases[f"rgb8{tag}"] = png_bytes(rgb, 2, interlace=interlace)
        cases[f"rgba8{tag}"] = png_bytes(rgba, 6, interlace=interlace)
        cases[f"rgb16{tag}"] = png_bytes(wide, 2, 16, interlace=interlace)
        cases[f"gray16{tag}"] = png_bytes(wide[:, :, 0], 0, 16, interlace=interlace)
        cases[f"graya16{tag}"] = png_bytes(wide[:, :, :2], 4, 16, interlace=interlace)
        for depth in (1, 2, 4):
            levels = np.random.default_rng(depth).integers(0, 1 << depth, (9, 14))
            cases[f"gray{depth}{tag}"] = png_bytes(levels, 0, depth, interlace=interlace)
            pal = np.random.default_rng(depth + 9).integers(0, 256, (1 << depth, 3)).astype(np.uint8)
            cases[f"palette{depth}{tag}"] = png_bytes(levels, 3, depth, interlace=interlace, palette=pal)
    return cases


PNG_CASES = png_cases()


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_png_decode_matches_jax(name):
    data = PNG_CASES[name]
    ours = nd.decode(data)
    np.testing.assert_array_equal(ours, jax_nd.decode(data))
    assert ours.dtype == np.uint8 and ours.shape[2] == 3


@pytest.mark.parametrize("path", JPEGS, ids=os.path.basename)
def test_jpeg_decode_matches_jax(path):
    data = pathlib.Path(path).read_bytes()
    np.testing.assert_array_equal(nd.decode(data), jax_nd.decode(data))


def test_decode_rejects_garbage():
    good = PNG_CASES["rgb8"]
    crc_broken = bytearray(good)
    crc_broken[40] ^= 0xFF  # inside IDAT: its CRC no longer holds
    for bad in (b"not an image at all", good[:60], good[:-12], bytes(crc_broken), b"\xff\xd8\xff" + b"\0" * 20):
        with pytest.raises(ValueError):
            nd.decode(bad)
        with pytest.raises(ValueError):
            jax_nd.decode(bad)


def test_transforms_match_jax():
    rng_src = np.random.default_rng(5)
    for i in range(12):
        h, w = (int(v) for v in rng_src.integers(8, 90, 2))
        rgb = rng_src.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n_px = int(rng_src.choice([16, 32, 48]))
        np.testing.assert_array_equal(nd.eval_transform_from_rgb(rgb, n_px), jax_nd.eval_transform_from_rgb(rgb, n_px))
        np.testing.assert_array_equal(
            nd.train_transform_from_rgb(rgb, n_px, np.random.default_rng(i)),
            jax_nd.train_transform_from_rgb(rgb, n_px, np.random.default_rng(i)))
        for train in (False, True):
            ours = nd.NativeTransform(n_px, train)
            ref = jax_nd.NativeTransform(n_px, train)
            img = Image.fromarray(rgb)
            np.testing.assert_array_equal(ours.from_rgb(rgb, np.random.default_rng(i)),
                                          ref(img, np.random.default_rng(i)))
            np.testing.assert_array_equal(ours(img, np.random.default_rng(i)), ref(img, np.random.default_rng(i)))


def test_from_rgb_converts_as_pillow():
    """Gray and RGBA arrays reach the transform as ``Image.fromarray(a).
    convert("RGB")`` gives them (the JAX package's ``.npy`` route)."""
    t, ref = nd.NativeTransform(24, False), jax_nd.NativeTransform(24, False)
    for arr in (photo(30, 41, 6)[:, :, 0], photo(33, 29, 7, channels=4)):
        np.testing.assert_array_equal(t.from_rgb(arr), ref(Image.fromarray(arr)))
    with pytest.raises(ValueError):
        t.from_rgb(np.zeros((4, 4, 2), np.uint8))


def test_crop_box_and_train_transform_match_jax():
    rng = np.random.default_rng(11)
    for i in range(300):
        w, h = (int(v) for v in rng.integers(1, 500, 2))
        assert (transforms.sample_resized_crop_box(w, h, np.random.default_rng(i))
                == jax_transforms.sample_resized_crop_box(w, h, np.random.default_rng(i)))
    # Extreme aspect ratios: every attempt fails, and the box is the center
    # crop at the nearest allowed ratio.
    for w, h in ((300, 5), (7, 260), (1000, 3)):
        box = transforms.sample_resized_crop_box(w, h, np.random.default_rng(w))
        assert box == jax_transforms.sample_resized_crop_box(w, h, np.random.default_rng(w))
        ch, cw = (h, int(round(h * 4 / 3))) if w > h else (int(round(w * 4 / 3)), w)
        assert box == ((h - ch) // 2, (w - cw) // 2, ch, cw)
    for i in range(20):
        img = Image.fromarray(photo(20 + i, 50 - i, i))
        np.testing.assert_array_equal(transforms.train_transform(16)(img, np.random.default_rng(i)),
                                      jax_transforms.train_transform(16)(img, np.random.default_rng(i)))
        np.testing.assert_array_equal(transforms.eval_transform(16)(img), jax_transforms.eval_transform(16)(img))


# ---------------------------------------------------------------- corpus ----

NAMES = ["tench", "goldfish", "great white shark", "tiger shark", "hammerhead shark"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """40 rows over PNG (four modes), the JPEG fixtures, uint8 and float
    ``.npy``; two guidance levels; img_ids repeated (and -1) so that the
    unstable sort shows; two extra caption columns."""
    root = tmp_path_factory.mktemp("torch_corpus")
    files = []
    for i in range(8):
        arr = photo(32 + 3 * i, 60 - 2 * i, 100 + i, channels=4 if i % 4 == 3 else 3)
        if i % 4 == 1:
            arr = arr[:, :, 0]
        path = root / f"img{i}.png"
        Image.fromarray(arr).save(path)
        files.append(str(path))
    files += JPEGS
    for i in range(3):
        arr = photo(40 + i, 36, 200 + i)
        np.save(root / f"u8_{i}.npy", arr)
        np.save(root / f"f32_{i}.npy", arr.astype(np.float32) / 255.0)
        files += [str(root / f"u8_{i}.npy"), str(root / f"f32_{i}.npy")]
    rng = np.random.default_rng(0)
    rows = ["title\tfilepath\tlabel\tguidance\timg_id\ttitle_1\ttitle_2"]
    for i in range(40):
        name = NAMES[i % len(NAMES)]
        img_id = -1 if i % 13 == 5 else int(rng.integers(0, 8))
        rows.append(f"a photo of a {name}.\t{files[i % len(files)]}\t{i % 5}\t{(100, 50)[i % 2]}\t{img_id}"
                    f"\ta {name} {i}\tthe {name}")
    path = root / "train.tsv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def configs(corpus, backend, **kw):
    common = dict(ft_data=corpus, ft_data_test=corpus, batch_size=8, workers=2, seed=3, data_backend=backend, **kw)
    return ExperimentConfig(**common), JaxConfig(**common)


def assert_batches_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("backend", ["threads", "native"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_csv_loader_matches_jax(corpus, backend, is_train):
    """Two epochs of the trainer-facing loader, bit for bit."""
    cfg, jcfg = configs(corpus, backend, get_labeled_csv=True)
    ours = csv_data.get_csv_loader(cfg, is_train=is_train, image_size=24)
    ref = jax_csv_data.get_csv_loader(jcfg, is_train=is_train, image_size=24)
    if not is_train:
        ours, ref = ours.test_loader, ref.test_loader
    assert isinstance(ours.dataset.transform, nd.NativeTransform) == (backend == "native")
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert_batches_equal(list(ours), list(ref))


DATASET_OPTIONS = {
    "guidance": dict(guidance=50),
    "datalimit": dict(guidance=100, datalimit=7),
    "ori_proportion": dict(guidance=50, ori_proportion=0.25, return_guidance=True),
    "list_selection": dict(label_key="label", list_selection=[1, 3]),
    "only_img_id": dict(only_img_id=True, return_img_id=True, label_key="label"),
    "all": dict(guidance=50, datalimit=9, ori_proportion=0.4, list_selection=[0, 2, 4], label_key="label",
                return_guidance=True, return_img_id=True, only_img_id=True),
}


@pytest.mark.parametrize("option", sorted(DATASET_OPTIONS))
def test_dataset_options_match_jax(corpus, option):
    kw = dict(DATASET_OPTIONS[option], seed=4)
    ours = csv_dataset.CsvContrastiveDataset(corpus, nd.NativeTransform(16, True), **kw)
    ref = jax_csv_dataset.CsvContrastiveDataset(corpus, jax_nd.NativeTransform(16, True), **kw)
    assert len(ours) == len(ref) > 0
    for attr in ("images", "captions", "extra_captions", "guidance", "img_id", "labels", "paths"):
        assert getattr(ours, attr, None) == getattr(ref, attr, None), attr
    dl = loader.DataLoader(ours, batch_size=4, num_workers=2, seed=1, drop_last=False)
    jdl = jax_loader.DataLoader(ref, batch_size=4, num_workers=2, seed=1, drop_last=False)
    assert_batches_equal(list(dl), list(jdl))


def test_only_img_id_sort_is_pandas_unstable_quicksort(tmp_path):
    """40 rows over 3 img_ids: the order of equal ids is numpy's quicksort's,
    which a stable sort does not give."""
    ids = np.random.default_rng(1).integers(0, 3, 40)
    path = tmp_path / "ids.tsv"
    path.write_text("title\tfilepath\tguidance\timg_id\n" + "".join(
        f"c{i}\tp{i}.png\t100\t{v}\n" for i, v in enumerate(ids)))
    ours = csv_dataset.CsvContrastiveDataset(str(path), None, only_img_id=True)
    ref = jax_csv_dataset.CsvContrastiveDataset(str(path), None, only_img_id=True)
    assert ours.captions == ref.captions
    assert ours.captions != [f"c{i}" for i in np.argsort(ids, kind="stable")]


@pytest.mark.parametrize("rank", [0, 1])
def test_two_way_sharding_matches_jax(corpus, rank):
    kw = dict(batch_size=4, num_workers=2, seed=2, process_index=rank, process_count=2)
    ours = csv_dataset.CsvContrastiveDataset(corpus, nd.NativeTransform(16, True))
    ref = jax_csv_dataset.CsvContrastiveDataset(corpus, jax_nd.NativeTransform(16, True))
    dl, jdl = loader.DataLoader(ours, **kw), jax_loader.DataLoader(ref, **kw)
    assert len(dl) == len(jdl) == 5
    assert_batches_equal(list(dl), list(jdl))


def test_fast_forward_matches_full_pass(corpus):
    cfg, jcfg = configs(corpus, "native")
    ours = csv_data.get_csv_loader(cfg, is_train=True, image_size=16)
    ref = jax_csv_data.get_csv_loader(jcfg, is_train=True, image_size=16)
    ours.set_epoch(1)
    full = list(ours)
    for k in (2, 4):
        ours.set_epoch(1, start_batch=k)
        ref.set_epoch(1, start_batch=k)
        skipped = list(ours)
        assert_batches_equal(skipped, full[k:])
        assert_batches_equal(skipped, list(ref))


def test_loader_abandoned_iterator_cancels_prefetch():
    import time

    fetched = []

    class DS:
        def __len__(self):
            return 400

        def get(self, idx, rng):
            fetched.append(idx)
            time.sleep(0.002)
            return {"x": np.zeros(1)}

    it = iter(loader.DataLoader(DS(), batch_size=8, num_workers=2, seed=0))
    next(it)
    it.close()
    assert len(fetched) < 200, f"prefetch ran {len(fetched)} decodes after abandon"


# ------------------------------------------------------ pandas-free read ----

TRICKY = ["", "NA", "None", "null", "n/a", "#N/A", "007", "1.50", "1e3", "true", "False", "a\tb", 'say "hi"',
          "  padded  ", "ünïcode", "-inf", ".5", "1_000", "0x10"]


@pytest.mark.parametrize("caption_col", [["plain", *TRICKY], ["1", "2", ""], ["1", "2.5", "NA"], ["True", "false"],
                                         ["12", "007", "+3"]],
                         ids=["mixed", "ints-with-na", "floats", "bools", "ints"])
def test_read_table_types_columns_as_pandas(tmp_path, caption_col):
    path = tmp_path / "t.tsv"
    df = pd.DataFrame({"title": caption_col, "filepath": [f"f{i}" for i in range(len(caption_col))],
                       "guidance": [100] * len(caption_col)})
    df.to_csv(path, sep="\t", index=False)
    ref = pd.read_csv(path, sep="\t")
    ours = csv_dataset.read_table(str(path), "\t")
    assert list(ours) == list(ref.columns)
    for col in ref.columns:
        assert [str(v) for v in ours[col]] == [str(v) for v in ref[col].tolist()], col
    assert [str(c) for c in csv_dataset.CsvContrastiveDataset(str(path), None).captions] == [
        str(c) for c in jax_csv_dataset.CsvContrastiveDataset(str(path), None).captions]


def test_read_table_refuses_what_pandas_reads_otherwise(tmp_path):
    """Kept differences (ROADMAP "Other differences"): a separator longer
    than one character (pandas reads it as a regex) and a row with more
    fields than the header (pandas shifts it into an index) raise."""
    path = tmp_path / "t.tsv"
    path.write_text("title::filepath\na::b\n")
    with pytest.raises(ValueError, match="one character"):
        csv_dataset.read_table(str(path), "::")
    path.write_text("title\tfilepath\na\tb\tc\n")
    with pytest.raises(ValueError, match="3 fields"):
        csv_dataset.read_table(str(path), "\t")


# ------------------------------------------------------------- prefetch ----

def test_prefetch_on_cpu_matches_jax(corpus):
    """Tokens shrunk as the JAX prefetch shrinks them, images cast to bf16
    bit-equal to ml_dtypes, paths left on the host."""
    import jax

    cfg, jcfg = configs(corpus, "native", get_labeled_csv=True)
    ours = list(loader.prefetch_to_device(csv_data.get_csv_loader(cfg, True, 16), "cpu", image_dtype=torch.bfloat16))
    ref = list(jax_loader.prefetch_to_device(jax_csv_data.get_csv_loader(jcfg, True, 16), None,
                                             image_dtype=ml_dtypes.bfloat16))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        assert a["image"].dtype == torch.bfloat16 and a["image"].device.type == "cpu"
        np.testing.assert_array_equal(a["image"].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(jax.device_get(b["image"])).view(np.uint16))
        assert a["tokens"].shape[1] < 77
        for k in ("tokens", "label"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
        assert a["path"] == b["path"]


def test_prefetch_refuses_several_processes(monkeypatch):
    """With several processes the token width is synchronised: each rank's
    shrink_context bucket goes through an all-reduce MAX (here a simulated
    second rank whose bucket is 48 wide) and narrower tokens are padded with
    zeros; the values before the pad are the rank's own, and a rank whose
    bucket is the widest keeps its width."""
    from flyp_tpu_torch.data import loader as mod

    tokens = np.zeros((2, 77), np.int32)
    tokens[:, 0] = 49406
    tokens[0, 1:5] = [10, 11, 12, 49407]
    tokens[1, 1:3] = [13, 49407]
    widths = []
    monkeypatch.setattr(mod, "process_count", lambda: 2)
    monkeypatch.setattr(mod, "max_int", lambda w: widths.append(w) or max(w, 48))
    (out,) = list(mod.prefetch_to_device(iter([{"tokens": tokens, "x": np.zeros(2)}]), "cpu"))
    own = widths[0]
    assert own < 48 and out["tokens"].shape == (2, 48)
    np.testing.assert_array_equal(out["tokens"][:, :own].numpy(), tokens[:, :own])
    assert not out["tokens"][:, own:].any()
    monkeypatch.setattr(mod, "max_int", lambda w: w)
    (out,) = list(mod.prefetch_to_device(iter([{"tokens": tokens}]), "cpu"))
    assert out["tokens"].shape == (2, own)


# ------------------------------------------------------- native library ----

def test_library_without_codecs_raises_named_error_and_falls_back(monkeypatch):
    """A build without a codec: its files raise CodecUnavailable from
    ``decode``; the transform decodes them with Pillow where it can, as the
    JAX package does for formats its library lacks, and raises the named
    error where Pillow is missing."""
    monkeypatch.setattr(nd, "probe_codecs", lambda: ())
    lib = nd.bind(nd.build())
    assert lib.flyp_codecs() == 0
    monkeypatch.setattr(nd, "load", lambda: lib)
    data = pathlib.Path(JPEGS[0]).read_bytes()
    with pytest.raises(nd.CodecUnavailable, match="JPEG.*jpeglib.h"):
        nd.decode(data)
    with pytest.raises(nd.CodecUnavailable, match="PNG.*zlib.h"):
        nd.decode(PNG_CASES["rgb8"])
    t = nd.NativeTransform(16, False)
    np.testing.assert_array_equal(t.from_bytes(data), jax_nd.NativeTransform(16, False).from_bytes(data))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(nd.CodecUnavailable):
        t.from_bytes(data)


def test_build_failure_names_the_compiler_message(monkeypatch, tmp_path):
    broken = tmp_path / "flyp_native.cc"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(nd, "SOURCE", broken)
    monkeypatch.setattr(nd, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nd, "probe_codecs", lambda: ())
    with pytest.raises(nd.NativeCompileError, match="(?s)g\\+\\+ failed.*error"):
        nd.build()
    assert not list((tmp_path / "build").glob("*"))


def test_library_is_named_by_source_and_flags(monkeypatch):
    with_png = nd.build()
    assert with_png == nd.build() and with_png.parent == REPO / "build" / "flyp_tpu_torch_host"
    monkeypatch.setattr(nd, "probe_codecs", lambda: ("jpeg",))
    assert nd.build() != with_png


# ------------------------------------------------- the card's imports ----

CARD_IMPORTS = r"""
import hashlib, json, sys
sys.modules["PIL"] = None
sys.modules["pandas"] = None
import torch
torch.set_num_threads(1)
from flyp_tpu_torch.config import parse_arguments
from flyp_tpu_torch.training.data import device_iter, train_loader
cfg = parse_arguments(["--ft_data", sys.argv[1], "--batch-size", "4", "--data_backend", "native", "--workers", "2"])
out = []
for batch in device_iter(train_loader(cfg, 24), "cpu", "bfloat16"):
    out.append({k: hashlib.sha256(v.contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
                for k, v in batch.items()})
import pkgutil, importlib, flyp_tpu_torch
for m in pkgutil.walk_packages(flyp_tpu_torch.__path__, "flyp_tpu_torch."):
    importlib.import_module(m.name)
print(json.dumps(out))
"""


def test_native_path_runs_without_pillow_and_pandas(tmp_path):
    """What the card machine may lack: with PIL and pandas blocked, the
    native-backend train loader and the prefetch run over PNG and ``.npy``
    rows and give the batches they give here, and every module of the
    port imports."""
    rows = ["title\tfilepath\tlabel\tguidance\timg_id"]
    for i in range(10):
        arr = photo(30 + i, 40, 300 + i)
        if i % 3 == 0:
            path = tmp_path / f"a{i}.npy"
            np.save(path, arr if i % 2 else arr.astype(np.float32) / 255.0)
        else:
            path = tmp_path / f"a{i}.png"
            Image.fromarray(arr).save(path)
        rows.append(f"a photo of a {NAMES[i % 5]}.\t{path}\t{i % 3}\t100\t{i}")
    tsv = tmp_path / "t.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", CARD_IMPORTS, str(tsv)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import hashlib

    from flyp_tpu_torch.config import parse_arguments
    from flyp_tpu_torch.training.data import device_iter, train_loader

    cfg = parse_arguments(["--ft_data", str(tsv), "--batch-size", "4", "--data_backend", "native", "--workers", "2"])
    here = [{k: hashlib.sha256(v.contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
             for k, v in batch.items()} for batch in device_iter(train_loader(cfg, 24), "cpu", "bfloat16")]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == here and len(here) == 2
