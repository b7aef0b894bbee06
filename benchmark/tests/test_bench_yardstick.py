"""The yardstick on the CPU: the analytic FLOP count against the program's
meta-tensor count, the bound arithmetic against the kernel table's bounds,
kernel names, trace reduction and the comparisons."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.yardstick import bounds, compare, flops, kernels, trace
from benchmark.yardstick.peaks import PEAKS, card_peaks

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "embed_dim": 32,
    "vision": {"image_size": 32, "patch_size": 8, "width": 64, "layers": 2, "heads": 1},
    "text": {"context_length": 77, "vocab_size": 100, "width": 64, "layers": 2, "heads": 1},
}


def _program_model(cfg):
    from flyp_tpu_torch.models import CLIPConfig, CLIPModel, TextConfig, VisionConfig

    v, t = cfg["vision"], cfg["text"]
    return CLIPModel(CLIPConfig(
        embed_dim=cfg["embed_dim"],
        vision=VisionConfig(image_size=v["image_size"], width=v["width"], patch_size=v["patch_size"],
                            layers=v["layers"], heads=v["heads"]),
        text=TextConfig(vocab_size=t["vocab_size"], width=t["width"], heads=t["heads"], layers=t["layers"])))


@pytest.mark.parametrize("batch,text_len", [(6, 16), (3, 21)])
def test_train_flops_match_program_count(batch, text_len):
    from flyp_tpu_torch.utils.profiling import clip_flops

    model = _program_model(TINY)
    images = torch.zeros(batch, 32, 32, 3)
    tokens = torch.zeros(batch, text_len, dtype=torch.int32)
    assert flops.train_step(TINY, batch, text_len) == clip_flops(model, images, tokens, train=True)


@pytest.mark.parametrize("images,classes", [(5, 10), (8, 1000)])
def test_serve_flops_match_program_count(images, classes):
    from flyp_tpu_torch.utils.profiling import clip_flops

    model = _program_model(TINY)
    count = clip_flops(model, torch.zeros(images, 32, 32, 3), None, train=False, head_classes=classes)
    assert flops.serve_images(TINY, images, classes) == count


def test_full_size_step_matches_kernel_table():
    """ViT-L/14's step at 256 (text width 32) is the 128.562 TFLOP that the
    program's count gave on the card."""
    cfg = json.loads((ROOT / "benchmark/configs/vit-l14.json").read_text())
    assert flops.train_step(cfg, 256, 32) / 1e12 == pytest.approx(128.5616, rel=1e-5)


@pytest.mark.parametrize("op,want_ms", [("B1", 0.271475), ("B3", 0.271475), ("B2", 0.498226)])
def test_bounds_match_kernel_table(op, want_ms):
    """The "Bound ms" of the kernel table at B=256, L=197, D=768, bf16."""
    peaks = PEAKS["sxm"]
    if op == "B2":
        got = bounds.backward_s(256, 197, 768, 12, False, peaks)
    else:
        got = bounds.forward_s(256, 197, 768, False, peaks)
    assert got * 1e3 == pytest.approx(want_ms, abs=5e-7)


def test_step_bound_sums_both_towers():
    peaks = PEAKS["sxm"]
    cfg = json.loads((ROOT / "benchmark/configs/vit-b16.json").read_text())
    vision = 12 * (bounds.forward_s(8, 197, 768, False, peaks) + bounds.backward_s(8, 197, 768, 12, False, peaks))
    text = 12 * (bounds.forward_s(8, 32, 512, True, peaks) + bounds.backward_s(8, 32, 512, 8, True, peaks))
    assert bounds.train_step_s(cfg, 8, 32, peaks) == pytest.approx(vision + text)
    assert bounds.serve_forward_s(cfg, 8, peaks) == pytest.approx(12 * bounds.forward_s(8, 197, 768, False, peaks))


def test_card_peaks_by_name():
    assert card_peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert card_peaks("NVIDIA H100 PCIe")["bf16"] == 756e12
    with pytest.raises(ValueError):
        card_peaks("cpu")


@pytest.mark.parametrize("mangled,want", [
    ("_ZN4flyp27attention_fwd_stream_kernelILb1ELb1EEEvNS_8AttnArgsE", "flyp::attention_fwd_stream_kernel"),
    ("_ZN12_GLOBAL__N_19ln_kernelEPKfPf", "ln_kernel"),
    ("_Z11gelu_kernelPKfPf", "gelu_kernel"),
    ("_ZNSt6vectorIiSaIiEE9push_backERKi", None),
])
def test_demangled_names(mangled, want):
    assert kernels.demangle_qualified(mangled) == want


@pytest.mark.parametrize("name,want", [
    ("void flyp::attention_fwd_stream_kernel<true, true>(flyp::AttnArgs)", "flyp::attention_fwd_stream_kernel"),
    ("void (anonymous namespace)::ln_kernel(float const*, float*)", "ln_kernel"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN"),
])
def test_trace_names(name, want):
    assert kernels.trace_name(name) == want


def test_library_names_read_from_bytes(tmp_path):
    lib = tmp_path / "libx.so"
    lib.write_bytes(b"\x00junk\x00_ZN4flyp11gemm_kernelEv\x00_Z3fooi\x00more")
    assert kernels.library_kernels(lib) == {"flyp::gemm_kernel", "foo"}


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0.0, "dur": 100.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50.0, "dur": 100.0, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400.0, "dur": 100.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 0.0, "dur": 900.0, "args": {"device": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 160.0, "dur": 300.0},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0.0, "dur": 1000.0},
    ]
    r = trace.reduce_events(ev, window_s=1e-3)
    assert r["busy_s"] == pytest.approx(250e-6)
    assert dict(r["device_ops"]) == pytest.approx({"k1": 1e-4, "k2": 1e-4, "Memcpy HtoD": 1e-4})
    assert [n for n, _ in r["kernels"]] == ["k1", "k2"]
    assert r["idle_gaps"] == [("aten::copy_", pytest.approx(250e-6))]


def test_train_numbers():
    ref = {"losses": [2.0, 1.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9}, "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    prog = {"losses": [2.002, 1.0], "grad": {"a": 1.1, "b": 2.0, "c": 0.0}, "change": {"a": 1.0, "b": 0.5, "c": 9.0}}
    n = compare.train_numbers(prog, ref)
    assert n["loss_gap"] == pytest.approx(1e-3)
    assert n["grad_gap"] == pytest.approx(0.1)  # against the median leaf's norm, 1.0
    assert n["change_gap"] == pytest.approx(0.5)  # leaf c has no gradient: left out
    assert compare.judge(n, {"loss_gap": 2e-3, "grad_gap": 0.2, "change_gap": 0.6})
    assert not compare.judge(n, {"loss_gap": 2e-3, "grad_gap": 0.05, "change_gap": 0.6})
    assert not compare.judge({"loss_gap": float("nan")}, {"loss_gap": 1.0})


def test_leaves_split_stacked_qkv():
    named = [("blk.attn.qkv_kernel", torch.ones(3, 2, 2)), ("blk.attn.qkv_bias", torch.zeros(3, 2)),
             ("w", torch.full((4,), 2.0))]
    norms = compare.leaf_norms(named)
    assert set(norms) == {"blk.attn.qkv_kernel.q", "blk.attn.qkv_kernel.k", "blk.attn.qkv_kernel.v",
                          "blk.attn.qkv_bias.q", "blk.attn.qkv_bias.k", "blk.attn.qkv_bias.v", "w"}
    assert norms["blk.attn.qkv_kernel.k"] == pytest.approx(2.0)
    assert norms["w"] == pytest.approx(4.0)


def test_serve_numbers():
    ref = torch.tensor([[0.1, 0.2], [0.3, 0.0]])
    assert compare.serve_numbers(ref.clone(), ref) == {"logit_err": 0.0}
    assert compare.serve_numbers(ref.roll(1, 0), ref)["logit_err"] == pytest.approx(0.2)
