"""The port's checkpoints (``flyp_tpu_torch/utils/checkpoint.py``) against
the JAX package's orbax ones, and the model factory's checkpoint loading.

A tiny CLIP (``tests/test_flyp_trainer.py::tiny_model``'s sizes) crosses
from the JAX package by ``from_jax_params``; two train steps give it
non-zero moments.  Every comparison is bit for bit: a checkpoint stores each
tensor in its own dtype, and JSON host state as the JAX package encodes it.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyp_tpu.training import flyp as jax_flyp
from flyp_tpu.training.schedules import warmup_cosine_lr as jax_warmup_cosine_lr
from flyp_tpu.training.train_state import TrainState as JaxTrainState
from flyp_tpu.training.train_state import make_optimizer as jax_make_optimizer
from flyp_tpu.utils import checkpoint as jax_checkpoint
from flyp_tpu_torch.cli import zeroshot_eval
from flyp_tpu_torch.models import CLIPModel, build_clip_model, convert, factory
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.training import create_train_state, flyp, make_optimizer, make_train_step, warmup_cosine_lr
from flyp_tpu_torch.utils import checkpoint
from tests.test_flyp_trainer import tiny_model

torch.set_num_threads(1)


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


@pytest.fixture(scope="module")
def tiny():
    jmodel, variables = tiny_model()
    return SimpleNamespace(jcfg=jmodel.config, config=port_config(jmodel.config),
                           params=jax.tree_util.tree_map(np.asarray, variables["params"]))


def _batch(B=4, seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, 16), np.int32)
    tokens[:, 0] = 49406
    for i, n in enumerate(rng.integers(3, 12, B)):
        tokens[i, 1:n] = rng.integers(1, 49000, n - 1)
        tokens[i, n] = 49407
    return torch.from_numpy(rng.standard_normal((B, 32, 32, 3)).astype(np.float32)), torch.from_numpy(tokens)


def _trained(tiny, moment_dtype, steps=2):
    """A port train state after ``steps`` steps, and its step function."""
    model = CLIPModel(tiny.config)
    model.load_state_dict(convert.from_jax_params(tiny.params))
    opt = make_optimizer(warmup_cosine_lr(1e-3, 2, 10), 0.1, moment_dtype)
    state, step = create_train_state(model, opt), make_train_step(model, opt)
    images, tokens = _batch()
    for _ in range(steps):
        state, _ = step(state, images, tokens)
    return state, opt, step


def _fresh(tiny, moment_dtype):
    model = CLIPModel(tiny.config).init_parameters(7)
    return create_train_state(model, make_optimizer(warmup_cosine_lr(1e-3, 2, 10), 0.1, moment_dtype))


def _leaves(state):
    opt = state.opt_state
    return ([t.detach().clone() for t in state.model.state_dict().values()]
            + [t.clone() for t in opt.mu + opt.nu] + [opt.count.clone()])


def _assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def _host_blob(seed=3):
    rng = np.random.default_rng(seed)
    rng.uniform(size=5)
    return {"last_perform": {"Guidance 2 Accuracy": 0.5, "Guidance 100 Accuracy": 0.875},
            "explore_rng": rng.bit_generator.state, "loss_pairs": [[201, 1.25], [300, np.float32(0.5)]],
            "progress_ma": {"2": [0.5, 0.625]}}


@pytest.mark.parametrize("moment_dtype, with_mid, with_host", [
    ("float32", False, False), ("float32", True, True), ("bfloat16", False, True), ("bfloat16", True, False)])
def test_round_trip_bit_for_bit(tiny, tmp_path, moment_dtype, with_mid, with_host):
    state, _, _ = _trained(tiny, moment_dtype)
    state.step = 2
    cursor = checkpoint.CurriculumCursor(1, None, 2, 1)
    mid = checkpoint.StepCursor(5, 3, 2, 7.25, 0.1) if with_mid else None
    host = _host_blob() if with_host else None
    path = checkpoint.save_checkpoint(str(tmp_path / "checkpoint_1_step_5"), state, cursor, mid=mid, host=host)
    assert sorted(os.listdir(path)) == ["batch_stats.pt", "meta.json", "opt_state.pt", "params.pt"]
    for name in ("params.pt", "opt_state.pt", "batch_stats.pt"):  # each a flat dict of tensors
        d = torch.load(os.path.join(path, name), weights_only=True)
        assert all(isinstance(k, str) and isinstance(v, torch.Tensor) for k, v in d.items())

    fresh = _fresh(tiny, moment_dtype)
    got = checkpoint.restore_checkpoint(path, fresh, mid=with_mid, host=True)
    _assert_leaves_equal(_leaves(got[0]), _leaves(state))
    assert got[0].step == 2 and got[0].opt_state.count.dtype == torch.int32
    assert got[1] == cursor
    if with_mid:
        assert got[2] == mid
    if with_host:
        restored = np.random.default_rng(0)
        restored.bit_generator.state = got[-1]["explore_rng"]
        reference = np.random.default_rng(3)
        reference.uniform(size=5)
        np.testing.assert_array_equal(restored.uniform(size=8), reference.uniform(size=8))
        assert got[-1]["loss_pairs"] == [[201, 1.25], [300, 0.5]]
    else:
        assert got[-1] is None
    if not with_mid:
        with pytest.raises(ValueError, match="no mid-epoch cursor"):
            checkpoint.restore_checkpoint(path, fresh, mid=True)


def test_host_state_bytes_equal_jax(tmp_path):
    blob = _host_blob()
    ours, ref = checkpoint._encode_host_state(blob), jax_checkpoint._encode_host_state(blob)
    assert ours.dtype == ref.dtype == np.uint8 and ours.tobytes() == ref.tobytes()
    assert blob["explore_rng"]["state"]["state"] > 2 ** 64  # a 128-bit PCG64 state
    assert checkpoint._decode_host_state(ref) == jax_checkpoint._decode_host_state(ours)
    state = SimpleNamespace(step=0, model=CLIPModel(port_config(tiny_model()[0].config)),
                            opt_state=SimpleNamespace(count=torch.zeros((), dtype=torch.int32), mu=[], nu=[]))
    path = checkpoint.save_checkpoint(str(tmp_path / "c"), state, host=blob)
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["host_state"].encode("utf-8") == ref.tobytes()


def _jax_state(tiny, moment_dtype, seed=0):
    """A JAX TrainState over the tiny params with random moments and count 9."""
    opt = jax_make_optimizer(jax_warmup_cosine_lr(1e-3, 2, 10), 0.1, moment_dtype)
    params = jax.tree_util.tree_map(jnp.asarray, tiny.params)
    opt_state = opt.init(params)
    rng = np.random.default_rng(seed)
    dtype = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    draw = lambda p: jnp.asarray(rng.standard_normal(p.shape), dtype)  # noqa: E731
    adam = opt_state.inner_state[0]
    adam = adam._replace(count=jnp.asarray(9, jnp.int32), mu=jax.tree_util.tree_map(draw, params),
                         nu=jax.tree_util.tree_map(lambda p: jnp.abs(draw(p)), params))
    opt_state = opt_state._replace(count=jnp.asarray(9, jnp.int32), inner_state=(adam, *opt_state.inner_state[1:]))
    return JaxTrainState(step=jnp.asarray(9, jnp.int32), params=params, opt_state=opt_state)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_orbax_state_equals_port_state_leaf_for_leaf(tiny, tmp_path, moment_dtype):
    """A JAX state through orbax and ``from_jax_train_state``, and the same
    JAX state carried across first and then through the port's format."""
    jstate = _jax_state(tiny, moment_dtype)
    cursor, mid, host = jax_checkpoint.CurriculumCursor(1, 100, 1, 1), jax_checkpoint.StepCursor(3, 2, 4, 1.5), {
        "last_perform": {}, "explore_rng": np.random.default_rng(0).bit_generator.state, "loss_pairs": [],
        "progress_ma": {}}
    jax_checkpoint.save_checkpoint(str(tmp_path / "orbax"), jstate, cursor, mid=mid, host=host)
    template = _jax_state(tiny, moment_dtype, seed=1)
    restored, jcursor, jmid, jhost = jax_checkpoint.restore_checkpoint(str(tmp_path / "orbax"), template, mid=True,
                                                                       host=True)
    via_orbax = convert.from_jax_train_state(restored.params, restored.opt_state, restored.step,
                                             CLIPModel(tiny.config))
    direct = convert.from_jax_train_state(jstate.params, jstate.opt_state, jstate.step, CLIPModel(tiny.config))
    want = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    assert all(m.dtype == want for m in direct.opt_state.mu + direct.opt_state.nu)
    assert direct.step == 9 and int(direct.opt_state.count) == 9
    path = checkpoint.save_checkpoint(
        str(tmp_path / "port"), direct, checkpoint.CurriculumCursor(**dataclasses.asdict(cursor)),
        mid=checkpoint.StepCursor(**dataclasses.asdict(mid)), host=host)
    through_port = checkpoint.restore_checkpoint(path, _fresh(tiny, moment_dtype), mid=True, host=True)
    _assert_leaves_equal(_leaves(through_port[0]), _leaves(via_orbax))
    assert through_port[0].step == via_orbax.step == 9
    assert dataclasses.asdict(through_port[1]) == dataclasses.asdict(jcursor)
    assert dataclasses.asdict(through_port[2]) == dataclasses.asdict(jmid)
    assert through_port[3] == jhost


def test_refusals_name_the_leaf_and_the_orbax_way_across(tiny, tmp_path):
    state, _, _ = _trained(tiny, None, steps=1)
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state)
    other = dataclasses.replace(tiny.config, vision=dataclasses.replace(tiny.config.vision, patch_size=8))
    cfg = SimpleNamespace(model="ViT-B/16", clip_load=path, compute_dtype="float32", seed=0)
    with pytest.raises(ValueError, match=r"parameter shapes differ — visual\.patch_kernel: saved \(16, 16, 3, 64\)"):
        build_clip_model(cfg, config_override=other, device="cpu")
    narrow = create_train_state(CLIPModel(other), make_optimizer(warmup_cosine_lr(1e-3, 2, 10), 0.1))
    with pytest.raises(ValueError, match=r"parameter shapes differ: visual\.patch_kernel"):
        checkpoint.restore_checkpoint(path, narrow)
    with pytest.raises(ValueError, match="moment mu/logit_scale"):
        checkpoint.restore_checkpoint(path, _fresh(tiny, "bfloat16"))
    with pytest.raises(ValueError, match="carries no batch_stats"):
        factory._load_checkpoint_dir(str(tmp_path / "ckpt"), "RN50", CLIPModel(tiny.config),
                                     batch_stats={"bn": torch.zeros(3)})

    jax_checkpoint.save_checkpoint(str(tmp_path / "orbax"), _jax_state(tiny, None))
    assert os.path.exists(tmp_path / "orbax" / "_CHECKPOINT_METADATA")
    for load in (lambda p: build_clip_model(SimpleNamespace(**{**vars(cfg), "clip_load": p}),
                                            config_override=tiny.config, device="cpu"),
                 lambda p: checkpoint.restore_checkpoint(p, _fresh(tiny, None)), checkpoint.restore_params):
        with pytest.raises(ValueError, match="tools/export_checkpoint.py"):
            load(str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="no meta.json"):
        checkpoint.restore_params(str(tmp_path))


def test_failed_save_leaves_no_visible_checkpoint(tiny, tmp_path, monkeypatch):
    state, _, _ = _trained(tiny, None, steps=1)
    before = _leaves(state)
    assert state.step == 1
    path = checkpoint.save_checkpoint(str(tmp_path / "checkpoint_0"), state)
    real_save = torch.save

    def failing(obj, f, *args, **kwargs):
        if str(f).endswith("opt_state.pt"):
            raise OSError("disk full")
        return real_save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(str(tmp_path / "checkpoint_1"), state)
    state.step = 5
    with pytest.raises(OSError, match="disk full"):  # over an existing checkpoint: the old one stays
        checkpoint.save_checkpoint(path, state)
    checkpoint.save_checkpoint(str(tmp_path / "checkpoint_2"), state, async_save=True)
    with pytest.raises(OSError, match="disk full"):  # an async commit's error surfaces at the wait
        checkpoint.wait_for_saves()
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_0"]
    monkeypatch.setattr(torch, "save", real_save)
    got = checkpoint.restore_checkpoint(path, _fresh(tiny, None))[0]
    _assert_leaves_equal(_leaves(got), before)
    assert got.step == 1


def test_async_save_survives_the_next_in_place_step(tiny, tmp_path, monkeypatch):
    """The staged payload is a copy: on the CPU ``.cpu()`` would be the live
    tensor, which the next step updates in place before the commit."""
    state, _, step = _trained(tiny, "bfloat16", steps=1)
    before = _leaves(state)
    gate = __import__("threading").Event()
    real_write = checkpoint._write_checkpoint_dir

    def held(*args):
        gate.wait(timeout=60)
        return real_write(*args)

    monkeypatch.setattr(checkpoint, "_write_checkpoint_dir", held)
    path = checkpoint.save_checkpoint(str(tmp_path / "checkpoint_0"), state, async_save=True)
    assert not os.path.exists(path)  # not committed: the name appears only at the rename
    images, tokens = _batch()
    step(state, images, tokens)
    after = _leaves(state)
    assert not all(torch.equal(a, b) for a, b in zip(after, before))
    gate.set()
    got = checkpoint.restore_checkpoint(path, _fresh(tiny, "bfloat16"))[0]  # waits for the commit
    _assert_leaves_equal(_leaves(got), before)


NAMES = ["checkpoint_0", "checkpoint_1_step_3", "checkpoint_1_step_11", "checkpoint_1_step_11.orbax-checkpoint-tmp-42",
         "checkpoint_1_step_12.tmp-17-0", "checkpoint_2.tmp-17-1", "checkpoint_2.old-17-2", "checkpoint_junk",
         "other_dir", "checkpoint_3_step_x", "checkpoint_", "checkpoint_0_step_", "checkpoint_1_step_2",
         "checkpoint_0_step_7"]


def test_checkpoint_names_match_jax(tmp_path):
    assert [flyp._parse_checkpoint_name(n) for n in NAMES] == [jax_flyp._parse_checkpoint_name(n) for n in NAMES]
    for n in ("checkpoint_1_step_12.tmp-17-0", "checkpoint_2.tmp-17-1", "checkpoint_2.old-17-2"):
        assert flyp._parse_checkpoint_name(n) is None
    for k in range(len(NAMES) + 1):  # the scan after each name appears
        ours, ref = tmp_path / f"ours{k}", tmp_path / f"ref{k}"
        for n in NAMES[:k]:
            (ours / n).mkdir(parents=True)
            (ref / n).mkdir(parents=True)
        ours.mkdir(exist_ok=True)
        ref.mkdir(exist_ok=True)
        got, want = flyp._latest_checkpoint(str(ours)), jax_flyp._latest_checkpoint(str(ref))
        assert (got and (got[0], os.path.basename(got[1]))) == (want and (want[0], os.path.basename(want[1])))
    for keep in (0, 1, 2, 3):
        ours, ref = tmp_path / f"prune_ours{keep}", tmp_path / f"prune_ref{keep}"
        for n in NAMES:
            (ours / n).mkdir(parents=True)
            (ref / n).mkdir(parents=True)
        flyp._prune_step_checkpoints(str(ours), keep=keep)
        jax_flyp._prune_step_checkpoints(str(ref), keep=keep)
        assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))


def test_factory_loads_trainer_and_bare_directories(tiny, tmp_path, monkeypatch):
    state, _, _ = _trained(tiny, "bfloat16")
    want = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    trainer = checkpoint.save_checkpoint(str(tmp_path / "checkpoint_0"), state)
    bare = checkpoint.save_params(str(tmp_path / "bare"), state.model)
    read = []
    real_load = checkpoint.load_tensors
    monkeypatch.setattr(checkpoint, "load_tensors", lambda p, name="params.pt", **kw: read.append(name) or
                        real_load(p, name, **kw))
    for path in (trainer, bare):
        read.clear()
        cfg = SimpleNamespace(model="ViT-B/16", clip_load=path, compute_dtype="float32", seed=0)
        model = build_clip_model(cfg, config_override=tiny.config, device="cpu")
        assert "opt_state.pt" not in read  # the moments are never read
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k
        assert not model.training and not any(p.requires_grad for p in model.parameters())
    assert checkpoint.read_meta(bare) == {"kind": "params", "format": 1}
    got = checkpoint.restore_params(bare, template=state.model)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="holds bare params"):
        checkpoint.restore_checkpoint(bare, _fresh(tiny, None))


def test_zeroshot_eval_save_writes_a_head_restore_params_reads(tiny, tmp_path, monkeypatch):
    from flyp_tpu_torch.config import ExperimentConfig

    model = CLIPModel(tiny.config)
    model.load_state_dict(convert.from_jax_params(tiny.params))
    ckpt = checkpoint.save_params(str(tmp_path / "clip"), model)
    cfg = ExperimentConfig(clip_load=ckpt, model="ViT-B/16", train_dataset="PatchCamelyonVal",
                           template="patchcamelyon_template", save=str(tmp_path / "out"), device="cpu",
                           log_dir=str(tmp_path / "logs"))
    heads = []
    real = zeroshot_eval.build_zeroshot_head
    monkeypatch.setattr(zeroshot_eval, "build_clip_model",
                        lambda c, device: build_clip_model(c, config_override=tiny.config, device=device))
    monkeypatch.setattr(zeroshot_eval, "build_zeroshot_head", lambda c, m: heads.append(real(c, m)) or heads[-1])
    assert zeroshot_eval.main(cfg) == {}  # no eval datasets: nothing evaluated, the head still saved
    head = checkpoint.restore_params(str(tmp_path / "out" / "zeroshot_head"))
    assert sorted(head) == ["bias", "weight"] and head["weight"].shape == (2, tiny.config.embed_dim)
    assert torch.equal(head["weight"], heads[0].weight.detach()) and torch.equal(head["bias"], heads[0].bias.detach())


def test_vit_checkpoint_files_keep_their_format(tiny, tmp_path):
    """A ViT (no BatchNorm) checkpoint is byte for byte what it was before
    parameters and running statistics were split: ``params.pt`` the host
    copies of ``state_dict()``, ``batch_stats.pt`` an empty dict."""
    state, _, _ = _trained(tiny, "bfloat16", steps=1)
    path = checkpoint.save_checkpoint(str(tmp_path / "checkpoint_0"), state)
    ref = tmp_path / "ref"
    ref.mkdir()
    torch.save({k: v.detach().to("cpu", copy=True) for k, v in state.model.state_dict().items()}, ref / "params.pt")
    torch.save({}, ref / "batch_stats.pt")
    for name in ("params.pt", "batch_stats.pt"):
        with open(os.path.join(path, name), "rb") as a, open(ref / name, "rb") as b:
            assert a.read() == b.read(), name


def test_resnet_checkpoint_splits_params_and_running_statistics(tmp_path):
    """A BatchNorm model: ``params.pt`` holds its parameters alone and
    ``batch_stats.pt`` its running statistics, both restored bit for bit
    (trainer checkpoints, ``save_params``/``restore_params`` and the
    factory); a checkpoint without statistics is refused."""
    from tests.test_flyp_trainer import tiny_resnet

    jmodel, variables = tiny_resnet()
    config = port_config(jmodel.config)
    host = jax.tree_util.tree_map(np.asarray, variables)
    model = CLIPModel(config)
    model.load_state_dict(convert.from_jax_params(host["params"], host["batch_stats"]), strict=True)
    opt = make_optimizer(warmup_cosine_lr(1e-3, 2, 10), 0.1, "bfloat16")
    state, step = create_train_state(model, opt), make_train_step(model, opt)
    images, tokens = _batch()
    for _ in range(2):
        state, _ = step(state, images, tokens)
    path = checkpoint.save_checkpoint(str(tmp_path / "checkpoint_0"), state)
    params = checkpoint.load_tensors(path)
    stats = checkpoint.load_tensors(path, checkpoint.STATS_FILE)
    assert list(params) == [n for n, _ in model.named_parameters()]
    assert list(stats) == [n for n, _ in model.named_buffers()] == list(state.batch_stats)
    assert "visual.layer1_0.bn1.mean" in stats and not torch.equal(stats["visual.bn1.var"], torch.ones(8))

    fresh = create_train_state(CLIPModel(config).init_parameters(7), make_optimizer(
        warmup_cosine_lr(1e-3, 2, 10), 0.1, "bfloat16"))
    got = checkpoint.restore_checkpoint(path, fresh)[0]
    _assert_leaves_equal(_leaves(got), _leaves(state))
    _assert_leaves_equal(list(got.batch_stats.values()), list(state.batch_stats.values()))

    bare = checkpoint.save_params(str(tmp_path / "bare"), model)
    assert sorted(os.listdir(bare)) == ["batch_stats.pt", "meta.json", "params.pt"]
    whole = checkpoint.restore_params(bare, template=model)
    assert list(whole) == list(params) + list(stats)
    want = model.state_dict()
    assert all(torch.equal(whole[k], want[k]) for k in want)
    for load in (path, bare):
        cfg = SimpleNamespace(model="RN50", clip_load=load, compute_dtype="float32", seed=0)
        loaded = build_clip_model(cfg, config_override=config, device="cpu")
        assert all(torch.equal(v, want[k]) for k, v in loaded.state_dict().items())

    import shutil

    stale = str(tmp_path / "stale")
    shutil.copytree(path, stale)
    torch.save({}, os.path.join(stale, checkpoint.STATS_FILE))
    with pytest.raises(ValueError, match=r"running statistics names differ \(missing \['visual\.bn1\.mean'"):
        checkpoint.restore_checkpoint(stale, fresh)
    with pytest.raises(ValueError, match="carries no batch_stats"):
        build_clip_model(SimpleNamespace(model="RN50", clip_load=stale, compute_dtype="float32", seed=0),
                         config_override=config, device="cpu")
    with pytest.raises(ValueError, match="running statistics names differ"):
        checkpoint.restore_params(stale, template=model)
