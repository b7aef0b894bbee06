"""The port's parallel layer (``flyp_tpu_torch/parallel``) against the JAX
package's, on the CPU.

The port's ranks are real ``gloo`` process groups on localhost, spawned once
per module by ``tests/torch_parallel_workers.py`` (2 ranks for every case
but the 4-rank TP x DP step); the JAX side runs in this process on the
virtual 8-device CPU mesh of ``tests/conftest.py``, its Pallas kernels in
interpret mode.  Inputs are seeded numpy arrays; weights cross through
``models/convert.from_jax_params``.

(a) the plain per-shard B1/B2/B3 (``partial`` / ``add_g=False``, Dv < D)
    against ``_fwd_call``/``_fwd_infer_call``/``_bwd_call`` with the same
    flags, and the 2-rank TP attention block (value and all seven grads)
    against ``attention_block`` on a ``(model=2)`` mesh;
(b) the gathered ``clip_loss`` (default, ``local_loss``, the three
    supervised variants), values and grads with ``logit_scale``'s, against
    ``tests/test_loss.py``'s shard_map forms;
(c) ``fsdp_spec``, the TP specs, the meshes and ``_mesh_batch_grid``'s
    layouts equal to JAX's;
(d) two train steps on data=2, replica=2, model=2, model=2 x data=2 and
    FSDP data=2 meshes against JAX's jitted step on the same mesh.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from __graft_entry__ import _tiny_config
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.ops.attention_block import _bwd_call, _fwd_call, _fwd_infer_call
from flyp_tpu.ops.attention_block import attention_block as jax_attention_block
from flyp_tpu.ops.losses import clip_loss as jax_clip_loss
from flyp_tpu.parallel import fsdp as jax_fsdp
from flyp_tpu.parallel import mesh as jax_mesh
from flyp_tpu.parallel import multihost as jax_multihost
from flyp_tpu.parallel import tp as jax_tp
from flyp_tpu.tokenizer import shrink_context
from flyp_tpu.training.schedules import warmup_cosine_lr as jax_warmup_cosine_lr
from flyp_tpu.training.train_state import create_train_state as jax_create_train_state
from flyp_tpu.training.train_state import make_optimizer as jax_make_optimizer
from flyp_tpu.training.train_step import make_train_step as jax_make_train_step
from flyp_tpu_torch.models import CLIPModel, convert
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.ops import attention_block as tab
from flyp_tpu_torch.parallel import fsdp, mesh as port_mesh, multihost, tp
from tests import torch_parallel_workers as workers

torch.set_num_threads(1)

HEADS, D = 4, 256  # two shards of 2 heads (Dv = 128)
SCHEDULE = (1e-3, 2, 10)  # warmup_cosine_lr: rates 5e-4, 1e-3 over the 2 steps
STEPS = 2
# Adam's first steps are sign-like (|update| ~ lr): a gradient element near
# 0 whose sign flips between two fp32 sums moves its parameter by up to 2 lr
# a step the other way (tests/test_torch_train_step.py's bound).
PARAM_ATOL = 2 * (5e-4 + 1e-3)
LOSS_VARIANTS = {"default": {}, "local_loss": {"local_loss": True}, "ignore": {"labels": True, "ignore": True},
                 "google": {"labels": True, "google_sup_loss": True}, "soft": {"labels": True}}
LAYOUTS = {"data2": (dict(data=2), False), "replica2": (dict(data=1, replica=2), False),
           "model2": (dict(data=1, model=2), False), "fsdp2": (dict(data=2), True)}
LAYOUTS4 = {"model2_data2": (dict(data=2, model=2), False)}
TP_ROUTES = ("pallas_block", "xla", "pallas_qkv", "pallas", "pallas_block_mlp")


def _block_inputs(B, L, seed, Dv=D):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        rng.standard_normal((B, L, D)).astype(f32),
        (1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
        (rng.standard_normal((3, D, Dv)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal((3, Dv))).astype(f32),
        (rng.standard_normal((Dv, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
    ), rng.standard_normal((B, L, D)).astype(f32)


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


def _batch(B=8, seed=0, vocab=1024, ctx=32):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    tokens = np.zeros((B, ctx), np.int32)
    tokens[:, 0] = vocab - 2
    for i, n in enumerate(rng.integers(6, 20, B)):
        tokens[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        tokens[i, n] = vocab - 1
    return images, shrink_context(tokens)


def _features(B=8, E=16, seed=3):
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    return (unit(rng.standard_normal((B, E))), unit(rng.standard_normal((B, E))), np.float32(10.0),
            rng.integers(0, 3, B).astype(np.int32))


@pytest.fixture(scope="module")
def tiny():
    jcfg = _tiny_config()
    jmodel = JaxCLIPModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jmodel, 0))
    return SimpleNamespace(jcfg=jcfg, jmodel=jmodel, params=params, config=port_config(jcfg),
                           state_dict=convert.from_jax_params(params), batch=_batch())


@pytest.fixture(scope="module")
def ranks(tiny):
    """Every 2-rank case in one process group, and the 4-rank step."""
    blocks = {(causal, train): _block_inputs(2, 13, seed=5 + 2 * causal + train) for causal in (False, True)
              for train in (False, True)}
    jobs = [(f"tp_block_{causal}_{train}", "tp_block", (*blocks[(causal, train)], HEADS, causal, train))
            for causal, train in blocks]
    jobs += [(f"block_{impl}_{train}", "tp_residual_block", (impl, train)) for impl in TP_ROUTES
             for train in (True, False)]
    jobs.append(("loss", "gathered_loss", (*_features(), LOSS_VARIANTS)))
    jobs.append(("collectives", "collectives", ()))
    jobs.append(("steps", "mesh_steps", (tiny.config, tiny.state_dict, tiny.batch, LAYOUTS, SCHEDULE, STEPS)))
    two = workers.run_ranks(workers.suite, 2, jobs)
    four = workers.run_ranks(workers.mesh_steps, 4, tiny.config, tiny.state_dict, tiny.batch, LAYOUTS4, SCHEDULE,
                             STEPS)
    return SimpleNamespace(two=two, four=four, blocks=blocks)


# --------------------------------------------------------- collectives ----


def test_collectives_on_two_ranks(ranks):
    """parallel/comm.py on a 2-rank gloo group, exactly: the sums, maxima,
    gathers and reduce-scatter of rank-dependent inputs, the bucketed sum
    with buckets smaller than a tensor, the host's max, and the transposes
    (gather_rows: the summed gradient of this rank's rows; reduce_from_group:
    the identity; copy_to_group: the sum; gather_shards: this rank's slice
    of its own gradient)."""
    world = 2
    base = np.arange(2 * world * 3, dtype=np.float32).reshape(2 * world, 3)
    xs = [base * (r + 1) for r in range(world)]
    total = sum(xs)
    for r, got in enumerate(ranks.two):
        c = {k: (v if not isinstance(v, torch.Tensor) else v.numpy()) for k, v in got["collectives"].items()}
        assert c["host_group"] is None  # the default group is gloo already
        np.testing.assert_array_equal(c["sum"], total)
        np.testing.assert_array_equal(c["max"], np.maximum(xs[0], xs[1] - 10))
        np.testing.assert_array_equal(c["gather0"], np.concatenate([x[:2] for x in xs], 0))
        np.testing.assert_array_equal(c["gather1"], np.concatenate([x[:2] for x in xs], 1))
        np.testing.assert_array_equal(c["scatter"], total[2 * r:2 * r + 2])
        for f, want in zip(c["flat"], (total, total[0, :2], total.T)):
            np.testing.assert_array_equal(f.numpy(), want)
        assert c["max_int"] == 5 + 3 * (world - 1)
        # d/d rows of sum(g^2) over every rank's copy of the gathered rows.
        np.testing.assert_array_equal(c["gather_rows_grad"], world * 2 * xs[r][:2])
        np.testing.assert_array_equal(c["reduce_grad"], np.full((2, 3), r + 1, np.float32))
        np.testing.assert_array_equal(c["copy_grad"], np.full((2, 3), sum(range(1, world + 1)), np.float32))
        # Every rank uses the gathered weight whole: its own slice of the
        # gradient, not the sum over the ranks.
        np.testing.assert_array_equal(c["gather_shards"], np.concatenate([x[:2] for x in xs], 1))
        np.testing.assert_array_equal(c["gather_shards_grad"], 2 * xs[r][:2])


# ---------------------------------------------------------------- (a) ----


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["fwd", "infer", "bwd"])
def test_shard_plain_versions_match_jax_kernels(kind, causal):
    """One shard's plain B1 (``partial``), B3 (``partial``) and B2
    (``add_g=False``) with Dv = 128 < D = 256 against the JAX kernels with
    the same flags in interpret mode: fp32 at 2e-5 (outputs) and 5e-4
    (backward sums), the bound of tests/test_torch_attention_block_train.py."""
    heads = HEADS // 2
    arrays, cot = _block_inputs(2, 13, seed=11 + causal, Dv=D // 2)
    t = [torch.from_numpy(a) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    if kind == "infer":
        got = tab.attention_block_inference_reference(*t, heads, causal, partial=True)
        ref = _fwd_infer_call(*j, heads, causal, True, partial_out=True)
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=2e-5)
        return
    got = tab.attention_block_reference(*t, heads, causal, partial=True)
    ref = _fwd_call(*j, heads, causal, True, partial_out=True)
    for name, a, b in zip(("out", "o", "q", "k", "v", "lse"), got, ref):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5, rtol=2e-5, err_msg=name)
    if kind == "fwd":
        return
    _, o, q, k, v, lse = got
    g = torch.from_numpy(cot)
    dx, dscale, dbias, dwqkv, dbqkv, _, _ = tab.attention_block_backward_reference(
        g, t[0], t[1], t[2], t[3], t[5], o, q, k, v, lse, heads, causal, add_g=False)
    jdx, jdw, jdb, jds, jdbias = _bwd_call(j[0], jnp.asarray(cot), *(jnp.asarray(_np(a)) for a in (q, k, v, lse)),
                                           j[1], j[2], j[3], j[5], heads, causal, True, add_g=False)
    for name, a, b in (("dx", dx, jdx), ("dwqkv", dwqkv, jdw), ("dbqkv", dbqkv, jdb),
                       ("dscale", dscale, jds.reshape(-1)), ("dbias", dbias, jdbias.reshape(-1))):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=5e-4, rtol=5e-4, err_msg=name)
    # add_g=False is the LayerNorm part alone: with g it is the whole dx.
    whole = tab.attention_block_backward_reference(g, t[0], t[1], t[2], t[3], t[5], o, q, k, v, lse, heads, causal)
    np.testing.assert_allclose(_np(whole[0]), _np(dx + g), atol=1e-6)


def _jax_tp_block(arrays, cot, causal):
    """JAX's attention_block (its custom partitioning's TP lowering) on a
    (model=2) mesh with the weights head-sharded: output and the seven
    grads, whole."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    specs = (P(), P(), P(), P(None, None, "model"), P(None, "model"), P("model", None), P())
    placed = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)) for a, s in zip(arrays, specs)]

    @jax.jit
    def run(*args):
        out, vjp = jax.vjp(lambda *a: jax_attention_block(*a, HEADS, causal, True), *args)
        return out, vjp(jnp.asarray(cot))

    out, grads = run(*placed)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_tp_block_matches_jax_on_model_mesh(ranks, causal, train):
    """The 2-rank TP block (B1/B2's plain versions per shard, or B3 with a
    backward that re-runs B1) against JAX on a (model=2) mesh: the output
    on both ranks and all seven grads (the shards' grads concatenated) in
    fp32 at 2e-5 and 5e-4, as the single-device op is held; both ranks hold
    the same output, x-grad and LN grads."""
    arrays, cot = ranks.blocks[(causal, train)]
    (out0, g0), (out1, g1) = (r[f"tp_block_{causal}_{train}"] for r in ranks.two)
    ref_out, ref_grads = _jax_tp_block(arrays, cot, causal)
    np.testing.assert_array_equal(out0, out1)
    np.testing.assert_allclose(out0, ref_out, atol=2e-5, rtol=2e-5)
    whole = {0: g0[0], 1: g0[1], 2: g0[2], 6: g0[6], 3: np.concatenate([g0[3], g1[3]], axis=-1),
             4: np.concatenate([g0[4], g1[4]], axis=-1), 5: np.concatenate([g0[5], g1[5]], axis=0)}
    for i in (0, 1, 2, 6):
        np.testing.assert_array_equal(g0[i], g1[i])
    for i, name in enumerate(("x", "ln_scale", "ln_bias", "qkv_kernel", "qkv_bias", "out_kernel", "out_bias")):
        np.testing.assert_allclose(whole[i], ref_grads[i], atol=5e-4, rtol=5e-4, err_msg=name)


# ---------------------------------------------------------------- (b) ----


def _jax_loss(variant):
    """tests/test_loss.py's shard_map forms on a (data=2) mesh: the loss
    (replicated, or each shard's rows with local_loss) and the grads of the
    objective each shard backpropagates (its rows' share of the global
    mean; a supervised scalar over 2), logit_scale's summed over the
    shards."""
    img, txt, scale, labels = _features()
    kw = dict(LOSS_VARIANTS[variant])
    use_labels = kw.pop("labels", False)
    local = kw.get("local_loss", False)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    b_global = img.shape[0]

    def device(i, t, s, lab):
        def objective(i, t, s):
            loss = jax_clip_loss(i, t, s, lab if use_labels else None, axis_name="data", **kw)
            if loss.ndim == 0:
                return loss / 2, loss
            return (jnp.sum(loss) / b_global if local else jnp.mean(loss) / 2), loss

        (_, loss), (gi, gt, gs) = jax.value_and_grad(objective, argnums=(0, 1, 2), has_aux=True)(i, t, s)
        return loss, gi, gt, jax.lax.psum(gs, "data")

    loss_spec = P("data") if local and not use_labels else P()
    fn = jax.shard_map(device, mesh=mesh, in_specs=(P("data"), P("data"), P(), P("data")),
                       out_specs=(loss_spec, P("data"), P("data"), P()), check_vma=False)
    return [np.asarray(a) for a in fn(jnp.asarray(img), jnp.asarray(txt), jnp.float32(scale), jnp.asarray(labels))]


@pytest.mark.parametrize("variant", list(LOSS_VARIANTS))
def test_gathered_loss_matches_jax_shard_map(ranks, variant):
    """Values and grads of the gathered loss on 2 ranks against JAX's
    axis_name forms, logit_scale's gradient included: 1e-5 (test_loss.py's
    shard_map bound)."""
    loss, gi, gt, gs = _jax_loss(variant)
    (l0, gi0, gt0, gs0), (l1, gi1, gt1, gs1) = (r["loss"][variant] for r in ranks.two)
    if variant == "local_loss":
        got_loss = np.concatenate([l0, l1])
    else:
        np.testing.assert_array_equal(l0, l1)
        got_loss = l0
    np.testing.assert_allclose(got_loss, loss, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([gi0, gi1]), gi, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.concatenate([gt0, gt1]), gt, atol=1e-5, rtol=1e-4)
    assert gs0 == gs1
    np.testing.assert_allclose(gs0, float(gs), atol=1e-6, rtol=1e-5)


def test_gathered_loss_gradient_is_the_global_mean(ranks):
    """The train step's objective summed over the ranks is the global mean:
    the gathered grads equal those of the one-process loss on the whole
    batch, logit_scale's included (1e-5)."""
    img, txt, scale, _ = _features()
    from flyp_tpu_torch.ops.losses import clip_loss

    i, t = (torch.from_numpy(a).requires_grad_(True) for a in (img, txt))
    s = torch.tensor(scale, requires_grad=True)
    gi, gt, gs = torch.autograd.grad(clip_loss(i, t, s).mean(), (i, t, s))
    for variant in ("default", "local_loss"):
        (_, gi0, gt0, gs0), (_, gi1, gt1, _) = (r["loss"][variant] for r in ranks.two)
        np.testing.assert_allclose(np.concatenate([gi0, gi1]), gi.numpy(), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(np.concatenate([gt0, gt1]), gt.numpy(), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(gs0, float(gs), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------- (c) ----


@pytest.mark.parametrize("data_size", [1, 2, 3, 4, 8])
def test_fsdp_spec_matches_jax(data_size):
    shapes = [(), (7,), (512,), (3, 768, 768), (768, 3072), (3072, 768), (49408, 512), (197, 768), (16, 16, 3, 768),
              (100, 300), (2 ** 15,), (2 ** 15 - 1,), (3, 512), (256, 128), (1024, 33)]
    for shape in shapes:
        want = tuple(jax_fsdp.fsdp_spec(shape, data_size))
        want = want + (None,) * (len(shape) - len(want))
        assert fsdp.fsdp_spec(shape, data_size) == want, shape
    assert fsdp.MIN_SHARD_ELEMENTS == jax_fsdp.MIN_SHARD_ELEMENTS


def _flat_specs(tree):
    return {k: tuple(v) for k, v in convert._flatten(tree, leaf=lambda s: s).items()}


def test_tp_specs_match_jax(tiny):
    """``clip_param_specs`` on the port's names equals JAX's on the JAX tree
    (each spec padded to its tensor's rank), and the parameters the port
    shards on a model=2 mesh are those JAX's ``shard_params`` shards."""
    model = CLIPModel(tiny.config)
    specs = tp.clip_param_specs(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = _flat_specs(jax_tp.clip_param_specs(tiny.params))
    assert sorted(specs) == sorted(want)
    for name, spec in specs.items():
        assert spec == want[name] + (None,) * (len(shapes[name]) - len(want[name])), name
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=1, model=2), devices=jax.devices()[:2])
    placed = jax_tp.shard_params(mesh, tiny.params)
    jax_sharded = {k for k, v in convert._flatten(placed, leaf=lambda a: a).items()
                   if any(ax is not None for ax in a_spec(v))}
    port = port_mesh.Mesh(np.arange(2).reshape(2, 1), ("model", "data"))
    port.coords = lambda rank=None: {"model": 0, "data": 0}
    layout = tp.shard_params(port, CLIPModel(tiny.config))
    assert set(layout) == jax_sharded
    for name, (axis, dim) in layout.items():
        assert axis == "model" and want[name][dim] == "model"


def a_spec(arr):
    return tuple(arr.sharding.spec)


MESH_CASES = [(dict(data=-1, model=1, replica=2), 12), (dict(data=-1, model=2), 6), (dict(data=-1, model=2), 8),
              (dict(data=4, model=2), 4), (dict(data=-1, model=1), 12), (dict(data=2, model=2, replica=2), 8)]


@pytest.mark.parametrize("config,batch", MESH_CASES)
def test_meshes_match_jax(monkeypatch, config, batch):
    """``create_mesh_for_batch`` over 8 ranks lays out the ranks as JAX lays
    out its 8 devices: the same axes, shape and order (rank = device id)."""
    monkeypatch.setattr(port_mesh, "world_size", lambda: 8)
    want = jax_mesh.create_mesh_for_batch(jax_mesh.MeshConfig(**config), batch)
    got = port_mesh.create_mesh_for_batch(port_mesh.MeshConfig(**config), batch)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.devices, np.vectorize(lambda d: d.id)(want.devices))
    assert port_mesh.batch_axes(got) == jax_mesh.batch_axes(want)


def test_mesh_refusals_match_jax(monkeypatch):
    monkeypatch.setattr(port_mesh, "world_size", lambda: 8)
    for fn in (lambda m: m.create_mesh(m.MeshConfig(data=3, model=1, replica=2)),
               lambda m: m.create_mesh_for_batch(m.MeshConfig(data=-1, model=1, replica=2), 7)):
        with pytest.raises(ValueError):
            fn(jax_mesh)
        with pytest.raises(ValueError):
            fn(port_mesh)


GRID_LAYOUTS = {
    "dp": ([[0, 0, 0, 0, 1, 1, 1, 1]], ("model", "data")),
    "tp": ([[0, 0, 0, 0], [1, 1, 1, 1]], ("model", "data")),
    "tpdp": ([[0, 0, 1, 1], [2, 2, 3, 3]], ("model", "data")),
    "replica": ([[[0, 0, 1, 1]], [[2, 2, 3, 3]]], ("replica", "model", "data")),
    "one_per_device": ([[0, 1], [2, 3]], ("model", "data")),
    "non_contiguous": ([[0, 1, 0, 1]], ("model", "data")),
}


@pytest.mark.parametrize("layout", list(GRID_LAYOUTS))
def test_mesh_batch_grid_matches_jax(monkeypatch, layout):
    """tests/test_multihost_input.py's layouts (devices owned by processes)
    and a one-device-a-process layout: the port's grid equals JAX's for
    every process, and both refuse a non-contiguous assignment."""
    assign, names = GRID_LAYOUTS[layout]
    arr = np.asarray(assign)
    jax_devices = np.empty(arr.shape, object)
    for idx in np.ndindex(arr.shape):
        jax_devices[idx] = SimpleNamespace(process_index=int(arr[idx]))
    jmesh = SimpleNamespace(devices=jax_devices, axis_names=names)
    pmesh = port_mesh.Mesh(arr, names)
    for me in sorted(set(arr.ravel().tolist())):
        monkeypatch.setattr(jax, "process_index", lambda me=me: me)
        if layout == "non_contiguous":
            with pytest.raises(ValueError, match="non-contiguous"):
                jax_multihost._mesh_batch_grid(jmesh)
            with pytest.raises(ValueError, match="non-contiguous"):
                multihost._mesh_batch_grid(pmesh, me=me)
            continue
        assert multihost._mesh_batch_grid(pmesh, me=me) == jax_multihost._mesh_batch_grid(jmesh)


def test_input_grid_is_pinned_and_reset(monkeypatch):
    """``configure_input_sharding`` pins the mesh's grid on a multi-process
    run, ``local_batch_size`` and the loaders read it, and
    ``reset_input_sharding`` unpins it; one process pins nothing."""
    mesh = port_mesh.Mesh(np.arange(4).reshape(2, 2), ("model", "data"))
    assert multihost.configure_input_sharding(mesh) == (0, 1) and multihost._INPUT_GRID is None
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    monkeypatch.setattr(multihost, "process_index", lambda: 2)
    try:
        assert multihost.configure_input_sharding(mesh) == (0, 2)
        assert multihost.input_shard_grid() == (0, 2) and multihost.local_batch_size(8) == 4
        assert multihost.resolve_process(None, None, shard_by_process=False) == (0, 1)
    finally:
        multihost.reset_input_sharding()
    assert multihost.input_shard_grid() == (2, 4)


# ---------------------------------------------------------------- (d) ----


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """JAX's jitted step on the same mesh (its first 2 or 4 virtual
    devices), placed as its trainer places it: losses, grad norms, params."""
    tiny_cfg = _tiny_config()
    jmodel = JaxCLIPModel(tiny_cfg)
    params = init_clip_params(jmodel, 0)
    config, fsdp_flag = {**LAYOUTS, **LAYOUTS4}[name]
    n = int(np.prod(list(config.values())))
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(**config), devices=jax.devices()[:n])
    opt = jax_make_optimizer(jax_warmup_cosine_lr(*SCHEDULE), weight_decay=0.1)
    state = jax_create_train_state(params, opt)
    if config.get("model", 1) > 1:
        state = jax_tp.shard_train_state(mesh, state)
    elif fsdp_flag:
        state = jax_fsdp.shard_train_state_fsdp(mesh, state)
    else:
        state = jax_mesh.replicate(mesh, state)
    shardings = jax.tree_util.tree_map(lambda x: x.sharding, state) if (config.get("model", 1) > 1 or fsdp_flag) \
        else None
    step = jax_make_train_step(jmodel, opt, mesh=mesh, donate=False, log_grad_norm=True, state_shardings=shardings)
    images, tokens = jax_mesh.shard_batch(mesh, _batch())
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, images, tokens)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("name", [*LAYOUTS, *LAYOUTS4])
def test_mesh_step_matches_jax(ranks, name):
    """Two steps of the port's step on each mesh (each rank its rows, TP
    blocks on the model axis, FSDP shards reduce-scattered) against JAX's
    jitted step on the same mesh: the losses at 1e-6 (step 0) and 1e-4
    (step 1), the grad norms at 1e-4, the whole parameters after within
    twice the summed rates with a median under 1e-7 (fp32 sums in another
    order; Adam's sign-like first steps)."""
    got = (ranks.four[0] if name in LAYOUTS4 else ranks.two[0]["steps"])[name]
    losses, norms, params = _jax_steps(name)
    np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-6)
    np.testing.assert_allclose(got["losses"][1], losses[1], rtol=1e-4)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-4)
    ref = convert.from_jax_params(params)
    assert sorted(got["params"]) == sorted(ref)
    diffs = []
    for k, v in got["params"].items():
        assert v.shape == tuple(ref[k].shape), k
        np.testing.assert_allclose(v, ref[k].numpy(), atol=PARAM_ATOL, rtol=1e-5, err_msg=k)
        diffs.append(np.abs(v - ref[k].numpy()).ravel())
    assert np.median(np.concatenate(diffs)) < 1e-7


@pytest.mark.parametrize("name", [*LAYOUTS, *LAYOUTS4])
def test_mesh_step_layout_at_rest(ranks, tiny, name):
    """The shards each rank held at rest: TP's as JAX's specs cut them (a
    model-axis shard of every attn/mlp weight), FSDP's as ``fsdp_spec``
    cuts them, the moments the same shape as what they follow; DP and the
    replica axis hold everything whole."""
    got = (ranks.four[0] if name in LAYOUTS4 else ranks.two[0]["steps"])[name]
    config, fsdp_flag = {**LAYOUTS, **LAYOUTS4}[name]
    whole = {k: tuple(v.shape) for k, v in tiny.state_dict.items()}
    assert got["moments"] == got["held"]
    for k, shape in got["held"].items():
        if config.get("model", 1) > 1:
            spec = tp._spec_for(k, whole[k])
        elif fsdp_flag:
            spec = fsdp.fsdp_spec(whole[k], config["data"])
        else:
            spec = (None,) * len(whole[k])
        n = 2
        want = tuple(d // n if ax is not None else d for d, ax in zip(whole[k], spec))
        assert shape == want, k
        assert (k in got["layout"]) == any(ax is not None for ax in spec), k


# ------------------------------------------------------- TP routes ----


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("impl", TP_ROUTES)
def test_tp_residual_block_matches_whole_block(ranks, impl, train):
    """A transformer block sharded over 2 ranks (``tp.shard_params``) on
    each route, in training and eval mode, against the same block whole in
    one process: the output and the grads of x and of every parameter (the
    shards' concatenated along their sharded dim) at 1e-5.  ``pallas_qkv``
    and ``pallas`` run their attention on the local heads,
    ``pallas_block_mlp`` its MLP sub-block whole on the gathered weights."""
    out0, grads0, layout = ranks.two[0][f"block_{impl}_{train}"]
    out1, grads1, _ = ranks.two[1][f"block_{impl}_{train}"]
    want_out, want_grads = workers.whole_block(impl, train)
    np.testing.assert_array_equal(out0, out1)
    np.testing.assert_allclose(out0, want_out, atol=1e-5, rtol=1e-5)
    assert sorted(layout) == ["attn.out_kernel", "attn.qkv_bias", "attn.qkv_kernel", "mlp.fc_bias",
                              "mlp.fc_kernel", "mlp.proj_kernel"]
    for name, want in want_grads.items():
        got = (np.concatenate([grads0[name], grads1[name]], axis=layout[name][1]) if name in layout
               else grads0[name])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=name)


def test_trainer_refuses_a_mesh_it_cannot_build(tmp_path):
    """One process asked for --mesh_model 2 raises: a mesh of 2 model ranks
    holds no data rank on one process."""
    from flyp_tpu_torch.config import ExperimentConfig
    from flyp_tpu_torch.training.flyp import build_mesh

    with pytest.raises(ValueError, match="covers 0 of 1 ranks"):
        build_mesh(ExperimentConfig(device="cpu", mesh_model=2, batch_size=8))
    assert build_mesh(ExperimentConfig(device="cpu", batch_size=8)).size == 1
