"""The general traffic generator: the same seed gives the same inputs, every
seed the same work, and the pad share counts the server's own chunks."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from benchmark import inputs, weights

ROOT = Path(__file__).resolve().parents[2]
SERVE = json.loads((ROOT / "benchmark/traffic/serve_mixed.json").read_text())
TRAIN = dict(json.loads((ROOT / "benchmark/traffic/train_b512.json").read_text()), batch=8, distinct_batches=2)
CFG = {"embed_dim": 16,
       "vision": {"image_size": 16, "patch_size": 8, "width": 64, "layers": 1, "heads": 1},
       "text": {"context_length": 77, "vocab_size": 49408, "width": 64, "layers": 1, "heads": 1}}
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_train_batches_repeat_for_a_seed(seed):
    a = inputs.train_batches(CFG, TRAIN, seed, CPU, torch.bfloat16)
    b = inputs.train_batches(CFG, TRAIN, seed, CPU, torch.bfloat16)
    c = inputs.train_batches(CFG, TRAIN, seed + 1, CPU, torch.bfloat16)
    for (ia, ta), (ib, tb), (ic, _) in zip(a, b, c):
        assert torch.equal(ia, ib) and torch.equal(ta, tb)
        assert not torch.equal(ia, ic)
    assert not torch.equal(a[0][0], a[1][0])  # distinct batches


def test_captions_have_the_mixes_lengths():
    tokens = inputs.captions(512, 77, (6, 20), (1, 49000), torch.Generator().manual_seed(3), CPU)
    eot = tokens.argmax(dim=1)
    assert tokens.dtype == torch.int32 and (tokens[:, 0] == inputs.SOT).all()
    assert (tokens[torch.arange(512), eot] == inputs.EOT).all()
    assert eot.min() >= 6 and eot.max() <= 19
    assert ((tokens > 0).sum(dim=1) == eot + 1).all()


def test_weights_repeat_for_a_seed():
    a, b, c = weights.make(CFG, 5, CPU), weights.make(CFG, 5, CPU), weights.make(CFG, 6, CPU)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["visual.proj"], c["visual.proj"])
    assert float(a["logit_scale"]) == pytest.approx(weights.LOGIT_SCALE_INIT)
    assert (a["visual.ln_pre.scale"] == 1).all() and (a["visual.ln_pre.bias"] == 0).all()


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11])
def test_requests_replay_one_trace(seed):
    """Sizes and arrival times are the mix's trace whatever the seed; the
    images (pool offsets) are the seed's."""
    a, b = inputs.requests(SERVE, seed, 64), inputs.requests(SERVE, seed + 1, 64)
    assert a == inputs.requests(SERVE, seed, 64)
    assert [n for _, n in a] == [n for _, n in b]
    assert [o for o, _ in a] != [o for o, _ in b]
    assert all(0 <= o and o + n <= SERVE["pool_images"] for o, n in a)
    t = inputs.arrival_times(SERVE, 64)
    assert t == inputs.arrival_times(SERVE, 64) and t == sorted(t)


def test_sizes_come_in_blocks_of_the_strata():
    k = SERVE["sizes"]["strata"]
    sizes = inputs.request_sizes(SERVE, 3, 4 * k)
    blocks = [sorted(sizes[i:i + k]) for i in range(0, 4 * k, k)]
    assert all(b == blocks[0] for b in blocks)
    assert blocks[0][0] >= SERVE["sizes"]["min"] and blocks[0][-1] <= SERVE["sizes"]["max"]


def test_arrivals_average_the_rate():
    k = SERVE["arrivals"]["strata"]
    t = inputs.arrival_times(SERVE, 8 * k)
    assert 8 * k / t[-1] == pytest.approx(SERVE["rate"], rel=0.05)


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_pad_share_on_hand_made_sizes():
    """Buckets (8, 64, 256): 5 -> 8, 64 -> 64, 65 -> 256, 300 -> 256 + 64."""
    from flyp_tpu_torch.serving import ClipServer

    from benchmark.drivers.serve import chunk_buckets

    srv = ClipServer(model=None, head=None, image_buckets=(8, 64, 256))
    sizes = [5, 64, 65, 300]
    computed = sum(b for n in sizes for b in chunk_buckets(srv, n))
    assert computed == 8 + 64 + 256 + 256 + 64
    ctx = {"kind": "serve", "rows": {"sent": sum(sizes), "computed": computed}}
    want = 100.0 * (648 - 434) / 648
    assert _reader("pad_share.serve")(ctx) == pytest.approx(want)
    assert _reader("pad_share.serve")({"kind": "train"}) is None


def test_readers_find_nothing_where_nothing_was_read():
    for name in ("mfu.train", "mfu.serve", "idle_share.train", "idle_share.serve", "peak_gib.train",
                 "attn_block_roofline.train", "attn_block_roofline.serve", "p50_ms.latency"):
        assert _reader(name)({}) is None
