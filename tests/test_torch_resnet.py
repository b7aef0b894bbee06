"""The port's ModifiedResNet tower (``flyp_tpu_torch/models/resnet.py``)
against the JAX package's, on the CPU.

The tiny RN config of the JAX tests (32 px, width 16, blocks (1, 1, 1, 1),
heads 8, a 64-wide 1-layer text tower) is initialised by the JAX package and
crosses to the port through ``from_jax_params(params, batch_stats)``; every
input is drawn from a seeded numpy generator.  fp32 throughout.  Tolerances
are stated where they are used: the port and XLA sum in other orders, and a
batch-normalised activation carries a difference of a few ulps of its
inputs' scale, so features agree to about 1e-6 of their size.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.models import convert as jax_convert
from flyp_tpu.models.clip import CLIPModel as JaxCLIPModel
from flyp_tpu.models.configs import CLIPConfig as JaxCLIPConfig
from flyp_tpu.models.configs import TextConfig as JaxTextConfig
from flyp_tpu.models.configs import VisionConfig as JaxVisionConfig
from flyp_tpu.models.resnet import AttentionPool2d as JaxAttentionPool2d
from flyp_tpu.models.resnet import Bottleneck as JaxBottleneck
from flyp_tpu.models.resnet import ModifiedResNet as JaxModifiedResNet
from flyp_tpu.models.resnet import TorchBatchNorm as JaxTorchBatchNorm
from flyp_tpu.training.schedules import warmup_cosine_lr as jax_warmup_cosine_lr
from flyp_tpu.training.train_state import create_train_state as jax_create_train_state
from flyp_tpu.training.train_state import make_optimizer as jax_make_optimizer
from flyp_tpu.training.train_step import make_train_step as jax_make_train_step
from flyp_tpu_torch.models import MODEL_CONFIGS, CLIPModel, build_clip_model, convert
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.models.resnet import (AttentionPool2d, Bottleneck, ModifiedResNet, TorchBatchNorm,
                                          running_stats_frozen)
from flyp_tpu_torch.serving import ClipServer
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr

torch.set_num_threads(1)

JCFG = JaxCLIPConfig(
    embed_dim=32,
    vision=JaxVisionConfig(image_size=32, width=16, patch_size=None, layers=0, heads=8, resnet_layers=(1, 1, 1, 1)),
    text=JaxTextConfig(context_length=16, vocab_size=128, width=64, heads=1, layers=1),
)


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batch(B=8, seed=0):
    """Images, and captions of BOS, random ids and EOT (the highest id)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((B, 16), np.int32)
    tokens[:, 0] = 126
    for i, n in enumerate(rng.integers(3, 12, B)):
        tokens[i, 1:n] = rng.integers(1, 126, n - 1)
        tokens[i, n] = 127
    return images, tokens


def nchw(x: np.ndarray) -> torch.Tensor:
    """An NHWC array as the channels-last NCHW view the port computes on."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_stats_close(port: torch.nn.Module, jax_stats, rtol=1e-6, atol=1e-7):
    """Every buffer of ``port`` against the flattened JAX ``batch_stats``."""
    want = convert.from_jax_params({}, host(jax_stats))
    got = dict(port.named_buffers())
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxCLIPModel(JCFG)
    images, tokens = batch()
    variables = host(jmodel.init(jax.random.key(0), jnp.asarray(images[:2]), jnp.asarray(tokens[:2])))
    return SimpleNamespace(jmodel=jmodel, params=variables["params"], stats=variables["batch_stats"])


def port_model(tiny) -> CLIPModel:
    model = CLIPModel(port_config(JCFG))
    model.load_state_dict(convert.from_jax_params(tiny.params, tiny.stats), strict=True)
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_jax(dtype):
    """Train mode: batch statistics, the biased variance in the output and
    the unbiased one in the running update; eval mode: the running
    statistics; statistics fp32 and the output in the activation type.
    fp32 output to 2e-6 of its unit scale, bf16 to one bf16 rounding."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 5, 5, 16)) * 3 + 1).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": rng.standard_normal(16).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(16)).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jbn = JaxTorchBatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt)
    bn = TorchBatchNorm(16)
    bn.load_state_dict(convert.from_jax_params(params, stats), strict=True)
    tol = 2e-6 if dtype == "float32" else 1e-2
    xj, xt = jnp.asarray(x, jdt), nchw(x).to(tdt)

    y, upd = jbn.apply({"params": params, "batch_stats": stats}, xj, use_running_average=False,
                       mutable=["batch_stats"])
    with torch.no_grad():
        with running_stats_frozen(bn):
            frozen = bn(xt)
        np.testing.assert_array_equal(bn.mean.numpy(), stats["mean"])  # not written
        np.testing.assert_array_equal(bn.var.numpy(), stats["var"])
        out = bn(xt)
    assert out.dtype == tdt and bn.mean.dtype == bn.var.dtype == torch.float32
    assert torch.equal(out, frozen)
    np.testing.assert_allclose(nhwc(out.float()), np.asarray(y, np.float32), rtol=tol, atol=tol)
    assert_stats_close(bn, upd["batch_stats"], rtol=2e-6, atol=1e-7)
    # 25 * 8 = 200 values a channel: the unbiased variance is 200/199 of the biased.
    batch_var = nhwc(xt.float()).reshape(-1, 16).astype(np.float64).var(axis=0)  # of the rounded input
    np.testing.assert_allclose(bn.var.numpy(), 0.9 * stats["var"] + 0.1 * batch_var * 200 / 199, rtol=1e-5)

    bn.eval()
    y_eval = jbn.apply({"params": params, "batch_stats": upd["batch_stats"]}, xj, use_running_average=True)
    with torch.no_grad():
        out_eval = bn(xt)
    np.testing.assert_allclose(nhwc(out_eval.float()), np.asarray(y_eval, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("inplanes, planes, stride", [(16, 8, 1), (32, 8, 1), (32, 16, 2)])
def test_bottleneck_matches_jax(inplanes, planes, stride):
    """The block in train mode (output, running statistics, gradients) and
    in eval mode; the downsample shortcut where the shape changes, the
    average pool before the strided convs."""
    x = np.random.default_rng(1).standard_normal((4, 8, 8, inplanes)).astype(np.float32)
    cot = np.random.default_rng(2).standard_normal((4, 8 // stride, 8 // stride, planes * 4)).astype(np.float32)
    jblock = JaxBottleneck(planes, stride)
    v = host(jblock.init(jax.random.key(3), jnp.asarray(x), train=False))
    block = Bottleneck(inplanes, planes, stride)
    block.load_state_dict(convert.from_jax_params(v["params"], v["batch_stats"]), strict=True)
    assert block.downsample == (stride > 1 or inplanes != planes * 4)

    def jloss(p):
        y, upd = jblock.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (y, stats)), grads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    block.train()
    out = block(nchw(x))
    g = torch.autograd.grad((out * nchw(cot)).sum(), list(block.parameters()))
    np.testing.assert_allclose(nhwc(out), np.asarray(y), rtol=1e-5, atol=1e-5)
    assert_stats_close(block, stats)
    want = convert.from_jax_params(host(grads))
    for (name, _), gt in zip(block.named_parameters(), g):
        np.testing.assert_allclose(gt.numpy(), want[name].numpy(), rtol=1e-4, atol=2e-4, err_msg=name)

    y_eval = jblock.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x), train=False)
    block.eval()
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(block(nchw(x))), np.asarray(y_eval), rtol=1e-5, atol=1e-5)


def test_attention_pool_matches_jax():
    """q for the mean token only, k and v over it and the HW positions,
    then c_proj; the output and the gradients of every projection."""
    x = np.random.default_rng(4).standard_normal((4, 2, 2, 128)).astype(np.float32)
    cot = np.random.default_rng(5).standard_normal((4, 32)).astype(np.float32)
    jpool = JaxAttentionPool2d(128, 2, 32)
    params = host(jpool.init(jax.random.key(6), jnp.asarray(x))["params"])
    pool = AttentionPool2d(2, 128, 128, 2, 32)
    pool.load_state_dict(convert.from_jax_params(params), strict=True)
    y, vjp = jax.vjp(lambda p: jpool.apply({"params": p}, jnp.asarray(x)), params)
    out = pool(nchw(x))
    g = torch.autograd.grad(out, list(pool.parameters()), torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    want = convert.from_jax_params(host(vjp(jnp.asarray(cot))[0]))
    for (name, _), gt in zip(pool.named_parameters(), g):
        np.testing.assert_allclose(gt.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("stem", ["reference", "s2d"])
def test_tower_matches_jax(stem):
    """The whole tower in train mode (features, every running statistic,
    every gradient) and in eval mode.  A JAX ``s2d`` model (its TPU stem
    layout: the same numbers) is held to the port's reference stem, which
    the port runs for either value."""
    jvision = dataclasses.replace(JCFG.vision, stem_impl=stem)
    images = batch()[0]
    cot = np.random.default_rng(7).standard_normal((8, 32)).astype(np.float32)
    jtower = JaxModifiedResNet(jvision, 32)
    v = host(jtower.init(jax.random.key(0), jnp.asarray(images[:2])))
    tower = ModifiedResNet(VisionConfig(**dataclasses.asdict(jvision)), 32)
    tower.load_state_dict(convert.from_jax_params(v["params"], v["batch_stats"]), strict=True)

    def jloss(p):
        y, upd = jtower.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(images), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (y, stats)), grads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    tower.train()
    out = tower(torch.from_numpy(images))
    g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), list(tower.parameters()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-5, atol=2e-5)
    assert_stats_close(tower, stats, rtol=1e-5, atol=1e-6)
    want = convert.from_jax_params(host(grads))
    largest = max(float(v.abs().max()) for v in want.values())
    for (name, _), gt in zip(tower.named_parameters(), g):
        if name == "attnpool.k_proj.bias":
            # Its exact gradient is 0 (a constant added to every key leaves
            # the softmax unchanged): both sides hold rounding noise.
            assert max(float(gt.abs().max()), float(want[name].abs().max())) < 1e-6 * largest
            continue
        scale = float(np.abs(want[name].numpy()).max())
        np.testing.assert_allclose(gt.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4 * scale, err_msg=name)

    y_eval = jtower.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(images), train=False)
    tower.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tower(torch.from_numpy(images)).numpy(), np.asarray(y_eval), rtol=1e-5, atol=2e-5)


def test_clip_model_matches_jax_in_both_modes(tiny):
    """The dual-tower forward: L2-normalised features and the scale, train
    mode (running statistics updated) and eval mode."""
    images, tokens = batch()
    model = port_model(tiny)
    (jf, jt, js), upd = tiny.jmodel.apply({"params": tiny.params, "batch_stats": tiny.stats}, jnp.asarray(images),
                                          jnp.asarray(tokens), train=True, mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        f, t, s = model(torch.from_numpy(images), torch.from_numpy(tokens))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    assert_stats_close(model.visual, upd["batch_stats"]["visual"], rtol=1e-5, atol=1e-6)
    jf_eval = tiny.jmodel.apply({"params": tiny.params, "batch_stats": upd["batch_stats"]}, jnp.asarray(images),
                                None, train=False)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model.encode_image(torch.from_numpy(images)).numpy(), np.asarray(jf_eval),
                                   rtol=1e-5, atol=5e-6)


def test_converter_round_trip_matches_jax(tiny, tmp_path):
    """The OpenAI layout both ways against the JAX converter: keys, shapes
    and values bit for bit, ``num_batches_tracked`` an int64 0; the config
    sniffed from the shapes; a ``.pt`` written and read back."""
    jexport = jax_convert.export_clip_state_dict(tiny.params, tiny.stats, JCFG)
    sd, config = convert.convert_clip_state_dict(jexport)
    assert config == port_config(JCFG)
    want = convert.from_jax_params(tiny.params, tiny.stats)
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    export = convert.export_clip_state_dict(sd, config)
    assert sorted(export) == sorted(jexport)
    for k, v in jexport.items():
        assert export[k].shape == v.shape and export[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(export[k].numpy(), v, err_msg=k)
    tracked = [k for k in export if k.endswith("num_batches_tracked")]
    assert len(tracked) == 3 + 4 * 3 + 4 and all(export[k].dtype == torch.int64 and int(export[k]) == 0
                                                  for k in tracked)
    convert.save_torch_checkpoint(str(tmp_path / "rn.pt"), export)
    loaded = convert.load_torch_checkpoint(str(tmp_path / "rn.pt"))
    assert all(loaded[k].dtype == torch.int64 for k in tracked)
    jparams, jstats, jconfig = jax_convert.convert_clip_state_dict(loaded)
    assert jconfig == JCFG
    for a, b in ((jparams, tiny.params), (jstats, tiny.stats)):
        fa, fb = convert.from_jax_params(a), convert.from_jax_params(b)
        assert sorted(fa) == sorted(fb) and all(torch.equal(fa[k], fb[k]) for k in fb)
    with pytest.raises(RuntimeError, match=r"Missing key\(s\).*visual\.bn1\.var"):  # the statistics are state
        CLIPModel(config).load_state_dict({k: v for k, v in sd.items() if not k.endswith(".var")}, strict=True)


SCHEDULE = (1e-3, 2, 10)
# As in tests/test_torch_train_step.py: a gradient near zero whose sign
# differs between the two frameworks' fp32 sums moves its parameter by up
# to 2 lr a step in Adam's sign-like first steps; twice the sum of the 3 rates.
PARAM_ATOL = 2 * (5e-4 + 1e-3 + 9.6e-4)


def test_train_step_trajectory_matches_jax(tiny):
    """3 AdamW steps of the direct step: losses (5e-6 at the first step:
    BatchNorm over 8 images divides by small deviations, which carries the
    two sums' rounding further than in a ViT; 1e-4 after), every parameter
    (PARAM_ATOL, median under 1e-7) and every running statistic after each
    step: after the first (a forward at equal weights) to 1e-5, after the
    others to 1e-3 with a median under 1e-7 (the statistics follow the
    weights, of which the first steps move a few by up to PARAM_ATOL)."""
    images, tokens = batch(seed=3)
    opt = jax_make_optimizer(jax_warmup_cosine_lr(*SCHEDULE), weight_decay=0.1)
    jstate = jax_create_train_state(tiny.params, opt, tiny.stats)
    jstep = jax_make_train_step(tiny.jmodel, opt, mesh=None, donate=False)
    model = port_model(tiny)
    popt = make_optimizer(warmup_cosine_lr(*SCHEDULE), weight_decay=0.1)
    state, step = create_train_state(model, popt), make_train_step(model, popt)
    assert sorted(state.batch_stats) == sorted(convert.from_jax_params({}, tiny.stats))
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(tokens))
        state, m = step(state, torch.from_numpy(images), torch.from_numpy(tokens))
        tol = 5e-6 if i == 0 else 1e-4
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=tol, err_msg=f"step {i}")
        np.testing.assert_allclose(m["per_item_loss"].numpy(), np.asarray(jm["per_item_loss"]), rtol=tol,
                                   atol=10 * tol)
        if i == 0:
            assert_stats_close(model, jstate.batch_stats, rtol=1e-5, atol=1e-6)
        else:
            assert_stats_close(model, jstate.batch_stats, rtol=0, atol=1e-3)
            want = convert.from_jax_params({}, host(jstate.batch_stats))
            diffs = np.concatenate([np.abs(v.numpy() - want[k].numpy()) for k, v in model.named_buffers()])
            assert np.median(diffs) < 1e-7, i
    want = convert.from_jax_params(host(jstate.params))
    diffs = []
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=PARAM_ATOL, err_msg=name)
        diffs.append(np.abs(p.detach().numpy() - want[name].numpy()).ravel())
    assert np.median(np.concatenate(diffs)) < 1e-7
    assert not torch.equal(model.visual.bn1.mean, torch.from_numpy(tiny.stats["visual"]["bn1"]["mean"]))


def test_factory_random_init_carries_batch_stats():
    """A random-init RN model has its running statistics (zeros and ones),
    drawn from CLIP's init distributions: lecun-normal convs and pool
    projections, a ``C**-0.5`` normal positional embedding; a ViT has none."""
    cfg = SimpleNamespace(model="RN50", clip_load=None, compute_dtype="float32", seed=0)
    model = build_clip_model(cfg, config_override=port_config(JCFG), device="cpu")
    stats = dict(model.named_buffers())
    assert len(stats) == 2 * (3 + 4 * 3 + 4) and create_train_state(model, make_optimizer(
        warmup_cosine_lr(*SCHEDULE), 0.1)).batch_stats.keys() == stats.keys()
    assert all(torch.equal(v, torch.zeros_like(v) if k.endswith(".mean") else torch.ones_like(v))
               for k, v in stats.items())
    pool = model.visual.attnpool
    C = pool.positional_embedding.shape[1]
    assert abs(pool.positional_embedding.std().item() * C ** 0.5 - 1) < 0.1
    assert abs(pool.q_proj.kernel.std().item() * C ** 0.5 - 1) < 0.05
    conv = model.visual.layer4_0.conv2.kernel  # 3 x 3 x 128 fan-in
    assert abs(conv.std().item() * (9 * 128) ** 0.5 - 1) < 0.05
    assert conv.abs().max().item() <= 2 / 0.87962566103423978 / (9 * 128) ** 0.5  # truncated at 2 sigma
    assert torch.equal(model.visual.bn1.scale, torch.ones(8))
    vit = build_clip_model(SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="float32", seed=0),
                           config_override=dataclasses.replace(
                               port_config(JCFG), vision=VisionConfig(image_size=32, width=64, patch_size=16,
                                                                      layers=1, heads=1)), device="cpu")
    assert dict(vit.named_buffers()) == {}
    assert create_train_state(vit, make_optimizer(warmup_cosine_lr(*SCHEDULE), 0.1)).batch_stats is None
    assert {k for k in MODEL_CONFIGS if not MODEL_CONFIGS[k].vision.is_vit} == {
        "RN50", "RN101", "RN50x4", "RN50x16", "RN50x64"}


def test_server_from_rn_checkpoint_matches_jax(tiny, tmp_path):
    """``ClipServer.from_checkpoint`` on an RN ``.pt`` written by the port's
    converter with running statistics moved by a train step: its features
    (eval mode: the running statistics) equal JAX's eval-mode features."""
    images, tokens = batch(seed=5)
    model = port_model(tiny)
    opt = make_optimizer(warmup_cosine_lr(*SCHEDULE), weight_decay=0.1)
    make_train_step(model, opt)(create_train_state(model, opt), torch.from_numpy(images), torch.from_numpy(tokens))
    path = str(tmp_path / "rn.pt")
    convert.save_torch_checkpoint(path, convert.export_clip_state_dict(model.state_dict(), port_config(JCFG)))
    srv = ClipServer.from_checkpoint(path, model="RN50", compute_dtype="float32", device="cpu")
    assert srv.model.config == port_config(JCFG)
    for k, v in model.state_dict().items():
        assert torch.equal(srv.model.state_dict()[k], v), k
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = jax_convert.convert_clip_state_dict(jax_convert.load_torch_checkpoint(path))[:2]
    want = tiny.jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(images), None, train=False)
    want = np.asarray(want) / np.linalg.norm(np.asarray(want), axis=-1, keepdims=True)
    np.testing.assert_allclose(srv.encode_images(images), want, rtol=1e-5, atol=2e-6)
    assert sd  # the server holds the trained state, not a fresh one
