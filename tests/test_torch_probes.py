"""The port's measurement probes (T1-T4) against the JAX tools.

Same numpy-seeded inputs through the JAX probes' Pallas kernels in interpret
mode and through the port's ops, whose CPU route is the plain PyTorch
version of each kernel:

* T1: ``tools.int8_matmul_probe._pallas_mm(..., interpret=True)`` at
  ``tests/test_tools.py``'s shapes (one N that does not divide 512) and at
  two M that are not a multiple of the card kernel's 128-row tile (200 and
  8).  int8 exactly equal; bf16 into fp32 within rtol 1e-5, atol 1e-4 (fp32
  summation order over K=768).
* T2-T4: ``tools/mfu_levers.py`` builds their ``pallas_call``s inside the
  probes at fixed TPU sizes, so these tests build the same ``pallas_call``s
  at small sizes, their kernel bodies copied from the tool;
  ``test_kernel_bodies_match_tool`` pins each copy to the tool's lines.
  T2: fp32 within rtol 1e-5, atol 1e-4.  T3: bf16 within one bf16 ulp
  (2^-7 |ref| + 1e-6) elementwise, mean absolute error under 1e-3.  T4: p
  within 1e-6 relative; the moments (fp32 or bf16) are the TPU body's
  uncontracted formula exactly, and where they differ from the JAX kernel's
  the JAX value is the FMA-contracted sum XLA emits on the CPU.

Then the ported tools end to end on the CPU at tiny sizes, printing their
lines in the JAX tools' formats.
"""

import dataclasses
import functools
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.mfu_levers as jax_levers
from flyp_tpu_torch.models import MODEL_CONFIGS
from flyp_tpu_torch.tools import int8_matmul_probe as tip
from flyp_tpu_torch.tools import mfu_levers as tml
from tools.int8_matmul_probe import _pallas_mm

torch.set_num_threads(1)

T1_SHAPES = [(1024, 768, 512), (512, 768, 2304), (512, 768, 768), (200, 768, 512), (8, 768, 128)]


# ---------------------------------------------------------------------------
# T1


@pytest.mark.parametrize("m,k,n", T1_SHAPES)
def test_probe_gemm_int8_exact(m, k, n):
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 127, (m, k)).astype(np.int8)
    b = rng.integers(-127, 127, (k, n)).astype(np.int8)
    ref = np.asarray(_pallas_mm(jnp.asarray(a), jnp.asarray(b), jnp.int32, interpret=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(tip.probe_mm(ta, tb, torch.int32).numpy(), ref)
    np.testing.assert_array_equal(tip.probe_mm_reference(ta, tb, torch.int32).numpy(), ref)


@pytest.mark.parametrize("m,k,n", T1_SHAPES)
def test_probe_gemm_bf16(m, k, n):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ref = np.asarray(_pallas_mm(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), jnp.float32,
                                interpret=True))
    ta, tb = torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    out = torch.full((m, n), float("nan"))
    got = tip.probe_mm(ta, tb, torch.float32, out=out)
    assert got is out
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tip.probe_mm_reference(ta, tb, torch.float32).numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,dtype,dim", [
    ((512, 768, 200), torch.int8, "N=200"), ((512, 100, 512), torch.bfloat16, "K=100"),
    ((512, 96, 512), torch.int8, "K=96"), ((0, 768, 512), torch.bfloat16, "M=0"),
])
def test_probe_gemm_refuses_shapes_it_cannot_tile(shape, dtype, dim):
    """The kernel's tiles need N % 128 and K % 32 (bf16) or 64 (int8); the
    op refuses any other shape on both devices, naming the dimension, as the
    TPU probe refuses a block that does not tile."""
    m, k, n = shape
    out = torch.int32 if dtype == torch.int8 else torch.float32
    with pytest.raises(ValueError, match=dim):
        tip.probe_mm(torch.zeros((m, k), dtype=dtype), torch.zeros((k, n), dtype=dtype), out)


def test_probe_gemm_types():
    with pytest.raises(TypeError):
        tip.probe_mm(torch.zeros((8, 64), dtype=torch.int8), torch.zeros((64, 128), dtype=torch.int8), torch.float32)


# ---------------------------------------------------------------------------
# T2-T4: the tool's kernel bodies at small sizes, in interpret mode.


def _score_kernel(Lp, D):
    def kernel(hd, q_ref, k_ref, o_ref):
        acc = jnp.zeros((Lp, Lp), jnp.float32)
        for h in range(D // hd):
            qh = q_ref[0, :, h * hd : (h + 1) * hd]
            kh = k_ref[0, :, h * hd : (h + 1) * hd]
            acc += jax.lax.dot_general(qh, kh, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
        o_ref[0] = acc

    return kernel


def _row_kernel():
    def kernel(x_ref, w_ref, o_ref):
        o_ref[0] = jax.lax.dot_general(
            x_ref[0], w_ref[:], (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
        ).astype(o_ref.dtype)

    return kernel


def _adamw_kernel():
    lr, b1, b2, eps, wd = 1e-5, 0.9, 0.999, 1e-8, 0.1

    def kernel(mdtype, p_ref, m_ref, v_ref, g_ref, np_ref, nm_ref, nv_ref):
        g32 = g_ref[:].astype(jnp.float32)
        m32 = m_ref[:].astype(jnp.float32) * b1 + (1 - b1) * g32
        v32 = v_ref[:].astype(jnp.float32) * b2 + (1 - b2) * g32 * g32
        mhat = m32 / (1 - b1 ** 10)
        vhat = v32 / (1 - b2 ** 10)
        p = p_ref[:]
        np_ref[:] = p - lr * (mhat / (jnp.sqrt(vhat) + eps) + wd * p)
        nm_ref[:] = m32.astype(mdtype)
        nv_ref[:] = v32.astype(mdtype)

    return kernel


def _kernel_body(factory) -> list:
    """The stripped lines of the ``kernel`` defined inside ``factory``."""
    lines = inspect.getsource(factory).splitlines()
    start = next(i for i, line in enumerate(lines) if line.strip().startswith("def kernel("))
    indent = len(lines[start]) - len(lines[start].lstrip())
    body = []
    for line in lines[start + 1:]:
        if line.strip() and len(line) - len(line.lstrip()) <= indent:
            break
        if line.strip():
            body.append(line.strip())
    return body


@pytest.mark.parametrize("factory", [_score_kernel, _row_kernel, _adamw_kernel])
def test_kernel_bodies_match_tool(factory):
    """Each copied body stands in ``tools/mfu_levers.py``, letter for letter
    (indentation aside), as consecutive lines."""
    body = _kernel_body(factory)
    tool = [line.strip() for line in inspect.getsource(jax_levers).splitlines() if line.strip()]
    assert len(body) >= 3
    assert any(tool[i:i + len(body)] == body for i in range(len(tool))), body


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _params():
    return pltpu.CompilerParams(vmem_limit_bytes=64 * 1024 * 1024)


@pytest.mark.parametrize("hd,Lp", [
    *(pytest.param(hd, 24, id=str(hd)) for hd in (64, 128, 256)),
    *(pytest.param(hd, 13, id=f"{hd}-L13") for hd in (64, 128, 256)),  # odd: the kernel masks columns past L
])
def test_score_depth_matches_tool_kernel(hd, Lp):
    B, D = 4, 256
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((B, Lp, D)).astype(np.float32)
    k = rng.standard_normal((B, Lp, D)).astype(np.float32)
    fn = pl.pallas_call(
        functools.partial(_score_kernel(Lp, D), hd),
        grid=(B,),
        in_specs=[_vmem((1, Lp, D), lambda b: (b, 0, 0)), _vmem((1, Lp, D), lambda b: (b, 0, 0))],
        out_specs=_vmem((1, Lp, Lp), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, Lp, Lp), jnp.float32),
        compiler_params=_params(),
        interpret=True,
    )
    ref = np.asarray(fn(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)))
    tq, tk = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k))
    got = tml.score_depth(tq, tk, hd)
    assert got.dtype == torch.float32 and got.shape == (B, Lp, Lp)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tml.score_depth_reference(tq, tk, hd).numpy(), ref, rtol=1e-5, atol=1e-4)


def test_score_depth_refuses():
    q = torch.zeros((2, 8, 192), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd=128"):
        tml.score_depth(q, q, 128)
    with pytest.raises(ValueError, match="hd=32"):
        tml.score_depth(q, q, 32)
    with pytest.raises(TypeError):
        tml.score_depth(q.float(), q.float(), 64)


def _bf16_close(got, ref):
    got, ref = got.astype(np.float32), ref.astype(np.float32)
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6)
    assert np.abs(got - ref).mean() < 1e-3


@pytest.mark.parametrize("R,D", [
    pytest.param(13, 256, id="13"), pytest.param(16, 256, id="16"),
    pytest.param(13, 40, id="13-D40"),  # D a multiple of 8 but not of 32: TMA's rows, not a k-tile
])
def test_row_gemm_matches_tool_kernel(R, D):
    B, N = 3, 256
    rng = np.random.default_rng(R)
    w = rng.standard_normal((D, N)).astype(np.float32)
    x = rng.standard_normal((B, R, D)).astype(np.float32)
    fn = pl.pallas_call(
        _row_kernel(),
        grid=(B,),
        in_specs=[_vmem((1, R, D), lambda b: (b, 0, 0)), _vmem((D, N), lambda b: (0, 0))],
        out_specs=_vmem((1, R, N), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, R, N), jnp.bfloat16),
        compiler_params=_params(),
        interpret=True,
    )
    ref = np.asarray(fn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    tx, tw = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, w))
    got = tml.row_gemm(tx, tw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, R, N)
    _bf16_close(got.float().numpy(), ref)
    _bf16_close(tml.row_gemm_reference(tx, tw).float().numpy(), ref)


def test_row_gemm_refuses():
    with pytest.raises(ValueError, match="N=200"):
        tml.row_gemm(torch.zeros((2, 5, 64), dtype=torch.bfloat16), torch.zeros((64, 200), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="D=44"):
        tml.row_gemm(torch.zeros((2, 5, 44), dtype=torch.bfloat16), torch.zeros((44, 128), dtype=torch.bfloat16))


def _adamw_inputs(rows, cols, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((rows, cols)).astype(np.float32)
    m = (0.01 * rng.standard_normal((rows, cols))).astype(np.float32)
    v = (1e-4 * rng.standard_normal((rows, cols)) ** 2).astype(np.float32)
    g = rng.standard_normal((rows, cols)).astype(np.float32)
    return p, m, v, g


@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
def test_adamw_update_matches_tool_kernel(mdtype):
    rows, cols, block = 32, 1024, 16
    jdt, tdt = getattr(jnp, mdtype), getattr(torch, mdtype)
    p, m, v, g = _adamw_inputs(rows, cols, seed=7)
    blk = _vmem((block, cols), lambda i: (i, 0))
    fn = pl.pallas_call(
        functools.partial(_adamw_kernel(), jdt),
        grid=(rows // block,),
        in_specs=[blk] * 4,
        out_specs=[blk] * 3,
        out_shape=[jax.ShapeDtypeStruct((rows, cols), jnp.float32), jax.ShapeDtypeStruct((rows, cols), jdt),
                   jax.ShapeDtypeStruct((rows, cols), jdt)],
        compiler_params=_params(),
        interpret=True,
    )
    ref = [np.asarray(t.astype(jnp.float32)) for t in fn(
        jnp.asarray(p), jnp.asarray(m, jdt), jnp.asarray(v, jdt), jnp.asarray(g, jnp.bfloat16))]
    tp = torch.from_numpy(p)
    tm, tv = (torch.from_numpy(t).to(tdt) for t in (m, v))
    tg = torch.from_numpy(g).to(torch.bfloat16)
    # A moment sums two fp32 terms: m b1 + (1 - b1) g, and v b2 + ((1 - b2) g) g.
    # The port rounds each term and then the sum (the TPU body's order, no
    # FMA); XLA on the CPU may contract the sum into an FMA.  So every moment
    # the port writes is the uncontracted formula's, and every one where the
    # two differ is a contracted form's (one fp32 ulp of the terms, more of
    # the sum where they cancel).
    f32, f64 = np.float32, np.float64
    m_in, v_in = (t.float().numpy() for t in (tm, tv))
    g_in = tg.float().numpy()
    gv = f32(0.001) * g_in
    forms = {  # moment: (uncontracted, [contracted forms])
        "m": (m_in * f32(0.9) + f32(0.1) * g_in,
              [m_in.astype(f64) * f64(f32(0.9)) + f64(1) * (f32(0.1) * g_in)]),
        "v": (v_in * f32(0.999) + gv * g_in,
              [v_in.astype(f64) * f64(f32(0.999)) + gv * g_in, gv.astype(f64) * g_in + v_in * f32(0.999)]),
    }

    def to_moment(x):
        return torch.from_numpy(np.asarray(x, f32)).to(tdt).float().numpy()

    plain = [t.float().numpy() for t in tml.adamw_update_reference(tp, tm, tv, tg, 10)]
    got = tml.adamw_update(tp, tm, tv, tg, 10)
    assert got[0] is tp and got[1] is tm and got[2] is tv  # in place
    for name, outs in (("kernel route", [t.float().numpy() for t in got]), ("plain", plain)):
        np.testing.assert_allclose(outs[0], ref[0], rtol=1e-6, atol=0, err_msg=name)
        for (moment, (flat, fused)), mom, r in zip(forms.items(), outs[1:], ref[1:]):
            np.testing.assert_array_equal(mom, to_moment(flat), err_msg=f"{name} {moment}")
            diff = mom != r
            explained = np.zeros_like(diff)
            for form in fused:
                explained |= to_moment(form) == r
            assert np.all(explained[diff]), (name, moment, int((diff & ~explained).sum()))


def test_adamw_update_refuses():
    p = torch.zeros(16)
    with pytest.raises(TypeError):
        tml.adamw_update(p, torch.zeros(16), torch.zeros(16, dtype=torch.bfloat16), p.bfloat16(), 10)
    with pytest.raises(ValueError, match="m is"):
        tml.adamw_update(p, torch.zeros(8), torch.zeros(8), p.bfloat16(), 10)


# ---------------------------------------------------------------------------
# The tools end to end on the CPU (the plain versions), at tiny sizes.

_RATE = r"\s+[\d.]+"


def test_int8_probe_main_cpu(capsys):
    tip.main(1, seq=8, width=128, iters=2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[:4] == ["shape", "bf16", "int8", "int8+dq"]
    names = ("qkv  [M,128]x[128,384]", "out  [M,128]x[128,128]", "mlp1 [M,128]x[128,512]", "mlp2 [M,512]x[512,128]")
    assert len(lines) == 5
    for name, line in zip(names, lines[1:]):
        assert re.fullmatch(re.escape(name) + r"\s+" + 3 * _RATE + r"   \(ms: [\d.]+ / [\d.]+ / [\d.]+\)", line), line


def test_int8_probe_main_pallas_cpu(capsys):
    before = (tip.probe_mm.bf16_launches, tip.probe_mm.int8_launches)
    tip.main_pallas(1, seq=8, width=128, iters=2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[:3] == ["shape", "bf16-pallas", "int8-pallas"]
    assert len(lines) == 3  # the CPU run drops the big square, as the JAX tool's interpret run does
    assert lines[1].startswith("qkv  [M,128]x[128,384]") and lines[2].startswith("out  [M,128]x[128,128]")
    assert (tip.probe_mm.bf16_launches, tip.probe_mm.int8_launches) == before  # no kernel on the CPU


def test_dynamic_quant_matches_jax_recipe():
    """``dynamic_quant_mm`` is the JAX tool's ``f_dq`` (round half to even)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b8 = rng.integers(-127, 127, (128, 128)).astype(np.int8)
    s = jnp.max(jnp.abs(jnp.asarray(a, jnp.bfloat16))).astype(jnp.float32) / 127.0
    a_q = jnp.clip(jnp.round(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32) / s), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot(a_q, jnp.asarray(b8), preferred_element_type=jnp.int32)
    ref = np.asarray(acc.astype(jnp.float32) * (s * jnp.float32(0.01)))
    got = tip.dynamic_quant_mm(torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b8), torch.tensor(0.01))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_mfu_levers_probes_cpu(capsys):
    tml.matmul_ceiling(M=64, K=128, N=256, BH=4, Lp=16, hd=64, iters=2, device="cpu")
    tml.pallas_score_depth(B=2, Lp=24, D=256, iters=2, device="cpu")
    tml.row_quant(B=2, D=128, N=256, rows=(13, 16), iters=2, device="cpu")
    tml.adamw_tail(16 * 1024, iters=2, device="cpu")
    tml.adamw_pallas(16 * 1024, block=4, iters=2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    patterns = [
        r"deep-K chain \[64x128x256\]x2:\s+[\d.]+ ms\s+[\d.]+ TFLOP/s",
        r"score mm  \[16x64\]x\[64x16\] x4:\s+[\d.]+ ms\s+[\d.]+ TFLOP/s  \(float32 out\)",
        r"pv mm     \[16x16\]x\[16x64\] x4:\s+[\d.]+ ms\s+[\d.]+ TFLOP/s  \(float32 out\)",
        r"score mm K=128 \(2 heads merged\):\s+[\d.]+ ms\s+[\d.]+ TFLOP/s  \(float32 out\)",
        *(rf"pallas score depth hd=\s*{hd}:\s+[\d.]+ ms\s+[\d.]+ TFLOP/s" for hd in (64, 128, 256)),
        *(rf"row_quant R=\s*{r}:\s+[\d.]+ ms\s+[\d.]+ TFLOP/s  \(\s*[\d.]+ us/program\)" for r in (13, 16)),
        *(rf"adamw {m} moments:\s+[\d.]+ ms  \(\s*\d+ GB/s apparent\)" for m in ("fp32", "bf16")),
        *(rf"adamw pallas {m} moments:\s+[\d.]+ ms  \(\s*\d+ GB/s apparent\)" for m in ("fp32", "bf16")),
    ]
    assert len(lines) == len(patterns), lines
    for pattern, line in zip(patterns, lines):
        assert re.fullmatch(pattern, line), (pattern, line)


def test_zeroshot_probe_cpu(capsys):
    cfg = MODEL_CONFIGS["ViT-B/16"]
    tiny = dataclasses.replace(
        cfg, embed_dim=64,
        vision=dataclasses.replace(cfg.vision, image_size=32, width=128, layers=1, heads=2),
        text=dataclasses.replace(cfg.text, width=128, heads=2, layers=2))
    tml.zeroshot_imagenet(num_classes=3, config=tiny, device="cpu")
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"zero-shot head 3x80 \(ViT-B/16\): first [\d.]+ s \(incl first-use builds\), "
                        r"steady [\d.]+ s/epoch, of which host tokenize ~[\d.]+ s", line), line


def test_clis_need_cuda_unless_asked_for_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA refusal needs a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tip.cli(["pallas", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tml.cli(["depth"])
    calls = []
    monkeypatch.setattr(tip, "main_pallas", lambda batch, device: calls.append(("pallas", batch, device)))
    monkeypatch.setattr(tip, "main", lambda batch, device: calls.append(("xla", batch, device)))
    tip.cli(["pallas", "4", "--device", "cpu"])
    tip.cli(["--device", "cpu"])
    monkeypatch.setitem(tml.PROBES, "depth", lambda device: calls.append(("depth", device)))
    tml.cli(["depth", "--device", "cpu"])
    assert calls == [("pallas", 4, "cpu"), ("xla", 256, "cpu"), ("depth", "cpu")]
