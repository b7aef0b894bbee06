"""The port's tar-shard pipeline against the JAX package's, on the CPU.

Worker threads interleave samples nondeterministically, so the loaders
are compared at ``num_workers=1``, where both yield one order.  Modelled on
``tests/test_webdataset.py``.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from flyp_tpu.data import native_decode as jax_nd
from flyp_tpu.data import webdataset as jax_wds
from flyp_tpu.data.transforms import eval_transform as jax_eval_transform
from flyp_tpu_torch.data import native_decode as nd
from flyp_tpu_torch.data import webdataset as wds
from flyp_tpu_torch.data.transforms import eval_transform

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def jax_native_library(tmp_path_factory):
    """The JAX package's library, built into this module's temporary
    directory (other test processes build the shared copy at the same
    time)."""
    saved = jax_nd._LIB, jax_nd._lib, jax_nd._failed
    jax_nd._LIB = str(tmp_path_factory.mktemp("jax_native") / "libflyp_native.so")
    jax_nd._lib, jax_nd._failed = None, False
    assert jax_nd.available()
    yield
    jax_nd._LIB, jax_nd._lib, jax_nd._failed = saved


def write_shard(path, rng, prefix, n=6, fmt="PNG"):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            key = f"{prefix}{i:04d}"
            img = Image.fromarray(rng.integers(0, 255, (36 + i, 40, 3), dtype=np.uint8))
            buf = io.BytesIO()
            img.save(buf, format=fmt)
            for ext, data in ((fmt.lower().replace("jpeg", "jpg"), buf.getvalue()),
                              ("txt", f"caption {key}".encode())):
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_wds")
    rng = np.random.default_rng(0)
    sizes = {}
    for s in range(4):
        name = f"shard-{s:05d}.tar"
        write_shard(root / name, rng, f"{s:05d}", fmt="JPEG" if s == 3 else "PNG")
        sizes[name] = 6
    with open(root / "sizes.json", "w") as f:
        json.dump(sizes, f)
    return str(root)


def transforms(kind):
    if kind == "threads":
        return eval_transform(24), jax_eval_transform(24)
    return nd.NativeTransform(24, train=True), jax_nd.NativeTransform(24, train=True)


def assert_same(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b) == ["image", "tokens"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("pattern", ["s-{00..02}.tar", "{a,b}/{0..1}", "x.tar::y-{7..9}.tar", "plain.tar",
                                     "odd-{x}.tar", "{001..010}"])
def test_braceexpand_matches_jax(pattern):
    assert wds.expand_urls(pattern) == jax_wds.expand_urls(pattern)
    assert wds.braceexpand(pattern) == jax_wds.braceexpand(pattern)


def test_dataset_size_matches_jax(shards, tmp_path):
    url = os.path.join(shards, "shard-{00000..00003}.tar")
    assert wds.get_dataset_size(url) == jax_wds.get_dataset_size(url) == 24
    (tmp_path / "__len__").write_text("17")
    url = str(tmp_path / "p-{0..1}.tar")
    assert wds.get_dataset_size(url) == jax_wds.get_dataset_size(url) == 17
    assert wds.get_dataset_size(str(tmp_path / "none" / "x.tar")) is None


@pytest.mark.parametrize("kind", ["threads", "native"])
def test_loader_matches_jax(shards, kind):
    ours_t, ref_t = transforms(kind)
    url = os.path.join(shards, "shard-{00000..00003}.tar")
    kw = dict(batch_size=4, num_workers=1, seed=5)
    for epoch in (0, 1):
        ours, ref = wds.WebDatasetLoader(url, ours_t, **kw), jax_wds.WebDatasetLoader(url, ref_t, **kw)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(ours) == len(ref) == 6
        assert_same(ours, ref)


def test_epoch_shuffle_and_resampling_match_jax(shards):
    url = os.path.join(shards, "shard-{00000..00003}.tar")
    for resampled in (False, True):
        kw = dict(batch_size=4, num_workers=1, resampled=resampled)
        orders = []
        for epoch in range(4):
            ours = wds.WebDatasetLoader(url, None, **kw)
            ref = jax_wds.WebDatasetLoader(url, None, **kw)
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert ours._epoch_shards() == ref._epoch_shards()
            orders.append(ours._epoch_shards())
        assert any(o != orders[0] for o in orders[1:])


def test_tolerates_corrupt_shard_as_jax(shards, tmp_path):
    bad = tmp_path / "bad.tar"
    bad.write_bytes(b"this is not a tar file")
    urls = [str(bad)] + wds.expand_urls(os.path.join(shards, "shard-{00000..00001}.tar"))
    ours_t, ref_t = transforms("native")
    kw = dict(batch_size=4, num_samples=12, num_workers=1)
    ours, ref = wds.WebDatasetLoader(urls, ours_t, **kw), jax_wds.WebDatasetLoader(urls, ref_t, **kw)
    assert_same(ours, ref)
    assert len(list(ours)) == 3


def test_node_split_and_starved_host_match_jax(shards):
    url = os.path.join(shards, "shard-{00000..00003}.tar")
    ours_t, ref_t = transforms("threads")
    keys = []
    for rank, count in ((0, 2), (1, 2), (5, 6)):
        kw = dict(batch_size=2, num_workers=1, num_samples=24, process_index=rank, process_count=count)
        ours, ref = wds.WebDatasetLoader(url, ours_t, **kw), jax_wds.WebDatasetLoader(url, ref_t, **kw)
        assert len(ours) == len(ref) == 24 // count // 2
        batches = list(ours)
        assert_same(batches, ref)
        assert len(batches) == len(ours)
        keys.append({tuple(b["tokens"][i]) for b in batches for i in range(2)})
    assert not (keys[0] & keys[1])


def test_skewed_shards_cycle_to_quota_as_jax(tmp_path):
    rng = np.random.default_rng(1)
    for s in range(3):
        write_shard(tmp_path / f"sk-{s:05d}.tar", rng, f"{s:05d}")
    url = os.path.join(str(tmp_path), "sk-{00000..00002}.tar")
    ours_t, ref_t = transforms("native")
    for rank in (0, 1):
        kw = dict(batch_size=2, num_workers=1, num_samples=18, process_index=rank, process_count=2)
        ours, ref = wds.WebDatasetLoader(url, ours_t, **kw), jax_wds.WebDatasetLoader(url, ref_t, **kw)
        assert len(ours) == 4
        assert_same(ours, ref)


def test_unknown_size_raises_as_jax(tmp_path):
    with pytest.raises(RuntimeError, match="number of dataset samples"):
        wds.WebDatasetLoader(str(tmp_path / "x-{0..1}.tar"), None, batch_size=2)


@pytest.mark.parametrize("path,kind", [("shards-{00000..00099}.tar", "auto"), ("data/shard.tar", "auto"),
                                       ("train.csv", "auto"), ("train.tsv", "auto"), ("train.csv", "webdataset"),
                                       ("x.tar", "csv")])
def test_is_webdataset_matches_jax(path, kind):
    assert wds.is_webdataset(path, kind) == jax_wds.is_webdataset(path, kind)


def test_several_workers_fill_the_epoch_from_the_shards(shards):
    """At four workers the order is the threads' race (a worker that
    finishes its shard cycles it until the quota is met): the epoch still
    has its batch count, and every sample is one of the shards'."""
    url = os.path.join(shards, "shard-{00000..00003}.tar")
    ours_t, _ = transforms("native")

    def rows(workers):
        loader = wds.WebDatasetLoader(url, ours_t, batch_size=4, num_workers=workers)
        batches = list(loader)
        assert len(batches) == len(loader) == 6
        return [b["tokens"][i].tobytes() for b in batches for i in range(4)]

    assert set(rows(4)) <= set(rows(1))
