"""The rest of the port's parallel layer against the JAX package's, on the
CPU: global-batch BatchNorm across ranks, the chunked (GradCache) step on a
mesh, and the opt-in attention routes under tensor parallelism.

The port's ranks are ``gloo`` process groups on localhost, spawned once for
the module by ``tests/torch_parallel_workers.py`` (one 2-rank group runs
every case, then one 4-rank group); the JAX side runs in this process on the
virtual 8-device CPU mesh of ``tests/conftest.py``.  Models are tiny: the
ModifiedResNet config of ``tests/test_torch_resnet.py`` (32 px, width 16,
blocks 1-1-1-1) and ``__graft_entry__._tiny_config``; weights cross through
``models/convert.from_jax_params``; inputs are seeded numpy arrays.

(i)   the synchronised BatchNorm layer on 2 ranks against the one-process
      layer on the concatenated batch, in float64, and the same layer with
      its backward's sum over the ranks left out (the transpose taken as
      the identity), which must fail;
(ii)  two AdamW steps of an RN CLIP on data=2, replica=2 and FSDP data=2
      meshes against JAX's jitted step on the same mesh, running
      statistics included and bit-equal across the ranks;
(iii) one SGD step of the chunked step (2 chunks) on data=2, FSDP data=2,
      model=2 and model=2 x data=2 meshes for the ViT and on a data=2 mesh
      for the RN against JAX's ``make_chunked_train_step(mesh=...)``; the
      RN batch's second global chunk is scaled 3x, so that the chunks'
      BatchNorm statistics differ, and the chunked step without its
      re-layout (a planted fault) must miss the loss;
(iv)  two AdamW steps on a model=2 mesh on the ``pallas_qkv``, ``pallas``
      and ``pallas_block_mlp`` routes against JAX's on the same mesh, its
      Pallas kernels in interpret mode.
"""

import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.ops import flash_attention as jax_flash_attention_mod
from flyp_tpu.ops.attention import _IMPL_ENV, _default_impl
from flyp_tpu.parallel import fsdp as jax_fsdp
from flyp_tpu.parallel import mesh as jax_mesh
from flyp_tpu.parallel import tp as jax_tp
from flyp_tpu.training import make_chunked_train_step as jax_make_chunked_train_step
from flyp_tpu.training.schedules import warmup_cosine_lr as jax_warmup_cosine_lr
from flyp_tpu.training.train_state import create_train_state as jax_create_train_state
from flyp_tpu.training.train_state import make_optimizer as jax_make_optimizer
from flyp_tpu.training.train_step import make_train_step as jax_make_train_step
from flyp_tpu_torch.models import convert
from flyp_tpu_torch.models.resnet import TorchBatchNorm
from flyp_tpu_torch.ops import attention as port_attention
from tests import torch_parallel_workers as workers
from tests.test_grad_cache import sgd_optimizer
from tests.test_torch_parallel import _batch as vit_batch
from tests.test_torch_parallel import port_config
from tests.test_torch_resnet import JCFG as RN_JCFG
from tests.test_torch_resnet import batch as rn_batch

torch.set_num_threads(1)

SCHEDULE = (1e-3, 2, 10)  # warmup_cosine_lr: rates 5e-4, 1e-3 over the 2 steps
STEPS = 2
LR = 0.05  # SGD, the chunked cases
# Adam's first steps are sign-like (|update| ~ lr): a gradient element near
# 0 whose sign flips between two fp32 sums moves its parameter by up to 2 lr
# a step the other way (tests/test_torch_parallel.py's bound).
PARAM_ATOL = 2 * (5e-4 + 1e-3)

RN = "rn"
VIT = "vit"
# name -> (model, MeshConfig kwargs, fsdp, impl, chunks)
DIRECT = {
    "rn_data2": (RN, dict(data=2), False, "xla", 1),
    "rn_replica2": (RN, dict(data=1, replica=2), False, "xla", 1),
    "rn_fsdp2": (RN, dict(data=2), True, "xla", 1),
    "tp_pallas_qkv": (VIT, dict(data=1, model=2), False, "pallas_qkv", 1),
    "tp_pallas": (VIT, dict(data=1, model=2), False, "pallas", 1),
    "tp_pallas_block_mlp": (VIT, dict(data=1, model=2), False, "pallas_block_mlp", 1),
}
CHUNKED = {
    "vit_chunk_data2": (VIT, dict(data=2), False, "xla", 2),
    "vit_chunk_fsdp2": (VIT, dict(data=2), True, "xla", 2),
    "vit_chunk_model2": (VIT, dict(data=1, model=2), False, "pallas_block", 2),
    "rn_chunk_data2": (RN, dict(data=2), False, "xla", 2),
}
CHUNKED4 = {"vit_chunk_model2_data2": (VIT, dict(data=2, model=2), False, "pallas_block", 2)}
FAULT = "rn_chunk_data2_" + workers.CONTIGUOUS_CHUNKS
CASES = {**DIRECT, **CHUNKED, **CHUNKED4}


def _bn_inputs():
    rng = np.random.default_rng(11)
    C = 6
    x = rng.standard_normal((8, 3, 5, C)) * rng.uniform(0.5, 3.0, C) + rng.standard_normal(C)
    return (x, rng.uniform(0.5, 1.5, C), 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C),
            rng.uniform(0.5, 2.0, C), rng.standard_normal(x.shape))


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, params, batch_stats or None, port config, state dict) by
    model kind."""
    out = {}
    jrn = JaxCLIPModel(RN_JCFG)
    images, tokens = rn_batch()
    v = jax.tree_util.tree_map(np.asarray, jrn.init(jax.random.key(0), jnp.asarray(images[:2]),
                                                    jnp.asarray(tokens[:2])))
    out[RN] = (jrn, v["params"], v["batch_stats"], port_config(RN_JCFG),
               convert.from_jax_params(v["params"], v["batch_stats"]))
    jvit = JaxCLIPModel(_tiny_config())
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jvit, 0))
    out[VIT] = (jvit, params, None, port_config(_tiny_config()), convert.from_jax_params(params))
    return out


def _case_batch(kind, chunks):
    """The seeded batch of ``kind``; for the chunked RN, its second global
    chunk scaled 3x."""
    images, tokens = rn_batch(seed=3) if kind == RN else vit_batch()
    if kind == RN and chunks > 1:
        images = images.copy()
        images[images.shape[0] // chunks:] *= 3.0
    return images, tokens


def _port_case(name, spec, fault=None):
    kind, mesh, fsdp, impl, chunks = spec
    _, _, _, config, state_dict = _models()[kind]
    case = dict(config=config, state_dict=state_dict, batch=_case_batch(kind, chunks), mesh=mesh, fsdp=fsdp,
                impl=impl, chunks=chunks, steps=1 if chunks > 1 else STEPS)
    if chunks > 1:
        case["sgd"] = LR
    else:
        case["schedule"] = SCHEDULE
    if fault:
        case["fault"] = fault
    return case


@pytest.fixture(scope="module")
def ranks():
    two_cases = {name: _port_case(name, spec) for name, spec in {**DIRECT, **CHUNKED}.items()}
    two_cases[FAULT] = _port_case(FAULT, CHUNKED["rn_chunk_data2"], workers.CONTIGUOUS_CHUNKS)
    jobs = [("bn", "synced_batch_norm", _bn_inputs()), ("steps", "a9b_steps", (two_cases,))]
    two = workers.run_ranks(workers.suite, 2, jobs)
    four = workers.run_ranks(workers.a9b_steps, 4, {n: _port_case(n, s) for n, s in CHUNKED4.items()})
    return SimpleNamespace(two=two, four=four)


# ---------------------------------------------------------------- (i) ----


def test_synced_batch_norm_matches_one_process_layer_in_float64(ranks):
    """The layer's output and x-grad on each rank's rows, the scale/bias
    grads summed over the ranks and the running statistics (equal on both
    ranks, bit for bit) against the one-process layer on the whole batch,
    float64 at 1e-12; with the backward's group sum left out, the x-grad
    misses by far more."""
    x, scale, bias, mean, var, cot = _bn_inputs()
    bn = TorchBatchNorm(x.shape[-1]).double()
    with torch.no_grad():
        for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean), (bn.var, var)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    dx, dscale, dbias = torch.autograd.grad(y, [xt, bn.scale, bn.bias], torch.from_numpy(cot).permute(0, 3, 1, 2))
    want = dict(y=y.detach().permute(0, 2, 3, 1).numpy(), dx=dx.permute(0, 2, 3, 1).numpy(), dscale=dscale.numpy(),
                dbias=dbias.numpy(), mean=bn.mean.numpy(), var=bn.var.numpy())
    sound = [r["bn"]["sound"] for r in ranks.two]
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([s[key] for s in sound]), want[key], rtol=1e-12, atol=1e-12,
                                   err_msg=key)
    for key in ("dscale", "dbias"):
        np.testing.assert_allclose(sound[0][key] + sound[1][key], want[key], rtol=1e-12, atol=1e-12, err_msg=key)
        assert not np.allclose(sound[0][key], want[key])  # each rank keeps its own rows' part
    for key in ("mean", "var"):
        np.testing.assert_array_equal(sound[0][key], sound[1][key])
        np.testing.assert_allclose(sound[0][key], want[key], rtol=1e-12, atol=1e-12, err_msg=key)
    planted = np.concatenate([r["bn"]["identity_transpose"]["dx"] for r in ranks.two])
    assert np.abs(planted - want["dx"]).max() > 1e-3


# -------------------------------------------------------- JAX references ----


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX's jitted step (direct or chunked) on the same mesh, placed as
    its trainer places it: losses, grad norms, per-item losses, params and
    running statistics."""
    kind, config, fsdp_flag, impl, chunks = CASES[name]
    jmodel, params, stats, _, _ = _models()[kind]
    saved = os.environ.get(_IMPL_ENV)
    os.environ[_IMPL_ENV] = impl
    _default_impl.cache_clear()
    port_attention._default_impl.cache_clear()
    real_flash = jax_flash_attention_mod.flash_attention
    # JAX's pallas route calls the flash kernel outside interpret mode,
    # which the CPU refuses: point it at the interpret-mode kernel.
    jax_flash_attention_mod.flash_attention = lambda q, k, v, causal=False, interpret=False: real_flash(
        q, k, v, causal, True)
    try:
        n = int(np.prod(list(config.values())))
        mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(**config), devices=jax.devices()[:n])
        opt = sgd_optimizer(LR) if chunks > 1 else jax_make_optimizer(jax_warmup_cosine_lr(*SCHEDULE),
                                                                      weight_decay=0.1)
        state = jax_create_train_state(params, opt, stats)
        tp = config.get("model", 1) > 1
        if tp:
            state = jax_tp.shard_train_state(mesh, state)
        elif fsdp_flag:
            state = jax_fsdp.shard_train_state_fsdp(mesh, state)
        else:
            state = jax_mesh.replicate(mesh, state)
        shardings = jax.tree_util.tree_map(lambda x: x.sharding, state) if (tp or fsdp_flag) else None
        kw = dict(mesh=mesh, donate=False, log_grad_norm=True, state_shardings=shardings)
        if chunks > 1:
            step = jax_make_chunked_train_step(jmodel, opt, chunks=chunks, **kw)
        else:
            step = jax_make_train_step(jmodel, opt, **kw)
        images, tokens = jax_mesh.shard_batch(mesh, _case_batch(kind, chunks))
        losses, norms, per_item = [], [], []
        for _ in range(1 if chunks > 1 else STEPS):
            state, m = step(state, images, tokens)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            per_item.append(np.asarray(m["per_item_loss"]))
        host = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
        return losses, norms, per_item, host[0], host[1]
    finally:
        jax_flash_attention_mod.flash_attention = real_flash
        if saved is None:
            os.environ.pop(_IMPL_ENV, None)
        else:
            os.environ[_IMPL_ENV] = saved
        _default_impl.cache_clear()
        port_attention._default_impl.cache_clear()


def _per_rank(ranks, name):
    return [r["steps"][name] for r in ranks.two] if name not in CHUNKED4 else [r[name] for r in ranks.four]


def _batch_ranks(name):
    """The ranks the batch splits over; ranks 0.. hold its blocks in order."""
    config = CASES[name][1]
    return config.get("data", 1) * config.get("replica", 1)


def _compare_params(got, want, atol, rtol=1e-5):
    ref = convert.from_jax_params(want)
    assert sorted(got) == sorted(ref)
    diffs = []
    for k, v in got.items():
        np.testing.assert_allclose(v, ref[k].numpy(), atol=atol, rtol=rtol, err_msg=k)
        diffs.append(np.abs(v - ref[k].numpy()).ravel())
    assert np.median(np.concatenate(diffs)) < 1e-7


def _compare_stats(per_rank, want):
    """Running statistics bit-equal across the ranks, and within 1e-3 of
    JAX's with a median under 1e-7 (tests/test_torch_resnet.py's bound
    after a step moved the weights)."""
    ref = convert.from_jax_params({}, want)
    assert sorted(per_rank[0]["stats"]) == sorted(ref)
    diffs = []
    for k, v in per_rank[0]["stats"].items():
        for other in per_rank[1:]:
            np.testing.assert_array_equal(other["stats"][k], v, err_msg=k)
        np.testing.assert_allclose(v, ref[k].numpy(), rtol=0, atol=1e-3, err_msg=k)
        diffs.append(np.abs(v - ref[k].numpy()).ravel())
    assert np.median(np.concatenate(diffs)) < 1e-7


# --------------------------------------------------------------- (ii) ----


@pytest.mark.parametrize("name", [n for n, s in DIRECT.items() if s[0] == RN])
def test_rn_mesh_step_matches_jax(ranks, name):
    """Two AdamW steps of the RN CLIP on each mesh, BatchNorm over the
    global batch: losses at 5e-6 (step 0) and 1e-4, grad norms at 1e-4,
    the per-item losses of the ranks' rows, the parameters within twice the
    summed rates (median under 1e-7), the running statistics bit-equal
    across ranks and to 1e-3 of JAX's (median under 1e-7)."""
    got = _per_rank(ranks, name)
    losses, norms, per_item, params, stats = _jax_run(name)
    for r in got:
        np.testing.assert_allclose(r["losses"][0], losses[0], rtol=5e-6)
        np.testing.assert_allclose(r["losses"][1], losses[1], rtol=1e-4)
        np.testing.assert_allclose(r["norms"], norms, rtol=1e-4)
    for i, want in enumerate(per_item):
        tol = 5e-6 if i == 0 else 1e-4
        np.testing.assert_allclose(np.concatenate([r["per_item"][i] for r in got[:_batch_ranks(name)]]), want,
                                   rtol=tol, atol=10 * tol)
    _compare_params(got[0]["params"], params, PARAM_ATOL)
    _compare_stats(got, stats)


# -------------------------------------------------------------- (iii) ----


@pytest.mark.parametrize("name", [*CHUNKED, *CHUNKED4])
def test_chunked_mesh_step_matches_jax(ranks, name):
    """One SGD step of the chunked step (2 chunks) on each mesh against
    JAX's chunked step on the same mesh: the loss at 1e-5, the grad norm
    at 1e-4, every parameter of the ViT at rtol 1e-5 / atol 5e-7 (the JAX
    tests' bounds of a chunked step against its oracle), of the RN at
    tests/test_grad_cache.py's bounds of a mesh step against one device
    (rtol 1e-3, atol 2e-6: its stem's gradient comes through BatchNorm
    over chunks of 4 images, a third of them scaled 3x); the RN's running
    statistics, chained through the two chunks, as in (ii)."""
    got = _per_rank(ranks, name)
    losses, norms, per_item, params, stats = _jax_run(name)
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["norms"], norms, rtol=1e-4)
    np.testing.assert_allclose(np.concatenate([r["per_item"][0] for r in got[:_batch_ranks(name)]]), per_item[0],
                               rtol=1e-5, atol=1e-5)
    if CASES[name][0] == RN:
        _compare_params(got[0]["params"], params, atol=2e-6, rtol=1e-3)
        _compare_stats(got, stats)
    else:
        _compare_params(got[0]["params"], params, atol=5e-7)


def test_chunked_rn_without_relayout_misses(ranks):
    """The planted fault: each rank's chunks are pieces of its own block,
    not its share of the global chunks, so the RN's BatchNorm sees other
    rows; the loss misses JAX's by more than 100 times the bound above."""
    got = _per_rank(ranks, FAULT)
    losses = _jax_run("rn_chunk_data2")[0]
    assert abs(got[0]["losses"][0] - losses[0]) > 100 * 1e-5 * abs(losses[0])


# --------------------------------------------------------------- (iv) ----


@pytest.mark.parametrize("name", [n for n, s in DIRECT.items() if s[0] == VIT])
def test_tp_routes_match_jax(ranks, name):
    """Two AdamW steps on a model=2 mesh on each route (B5, B6 on the local
    heads; B4 on the gathered MLP weights) against JAX's: losses at 1e-6
    and 1e-4, grad norms at 1e-4, the parameters within twice the summed
    rates (median under 1e-7), as tests/test_torch_parallel.py holds the
    pallas_block and xla routes."""
    got = _per_rank(ranks, name)
    losses, norms, _, params, _ = _jax_run(name)
    for r in got:
        np.testing.assert_allclose(r["losses"][0], losses[0], rtol=1e-6)
        np.testing.assert_allclose(r["losses"][1], losses[1], rtol=1e-4)
        np.testing.assert_allclose(r["norms"], norms, rtol=1e-4)
    _compare_params(got[0]["params"], params, PARAM_ATOL)


def test_chunked_step_refuses_a_chunk_the_ranks_do_not_split():
    """A chunk of 3 rows over 2 batch ranks raises ValueError before any
    collective (the JAX step pads the shards there; ROADMAP C)."""
    from flyp_tpu_torch.models import CLIPModel
    from flyp_tpu_torch.parallel import mesh as port_mesh
    from flyp_tpu_torch.training import create_train_state, make_train_step

    _, _, _, config, state_dict = _models()[VIT]
    model = CLIPModel(config)
    model.load_state_dict(state_dict, strict=True)
    mesh = port_mesh.Mesh(np.arange(2).reshape(1, 2), ("model", "data"))
    opt = workers.SGD(LR)
    state = create_train_state(model, opt)
    state.mesh = mesh
    step = make_train_step(model, opt, mesh=mesh, grad_cache_chunks=2)
    images, tokens = vit_batch(B=6)
    with pytest.raises(ValueError, match="does not split over 2 batch ranks"):
        step(state, torch.from_numpy(images[:3]), torch.from_numpy(tokens[:3]))
