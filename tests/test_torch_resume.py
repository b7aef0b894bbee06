"""Step checkpoints and resume in the port's trainer: an interrupted and
resumed run gives the uninterrupted run's checkpoints bit for bit.

Modelled on ``tests/test_midepoch_resume.py``, on the port alone (a run
against itself, so every comparison is exact): the tiny CLIP of
``tests/test_flyp_trainer.py`` on its corpus, ``--max_steps`` stopping
each run and one save and log directory shared by the invocations, as a
preemptible job keeps them.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from flyp_tpu_torch.models import CLIPModel, convert
from flyp_tpu_torch.training import flyp
from flyp_tpu_torch.utils import checkpoint
from tests.test_flyp_trainer import corpus, tiny_resnet  # noqa: F401
from tests.test_torch_flyp_trainer import port_cfg, port_config, port_model

torch.set_num_threads(1)


def _run(corpus, tmp_path, name, **flags):  # noqa: F811
    cfg = port_cfg(corpus, tmp_path, name, **flags)
    return cfg, flyp.flyp_train(cfg, model=port_model(), print_every=2)


def _assert_checkpoints_equal(a, b):
    for name in ("params.pt", "opt_state.pt", "batch_stats.pt"):
        ta, tb = checkpoint.load_tensors(a, name), checkpoint.load_tensors(b, name)
        assert list(ta) == list(tb)
        for k in ta:
            assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), (name, k)
    assert checkpoint.read_meta(a) == checkpoint.read_meta(b)


def _text(path):
    with open(path) as f:
        return f.read()


def _guidance_rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [(r["Epoch"], r["Image Guidance"]) for r in map(json.loads, f) if "Image Guidance" in r]


def test_max_steps_resume_is_bitwise_exact(corpus, tmp_path):  # noqa: F811
    """Stopped twice (in epoch 0, then in epoch 1): the checkpoints of both
    epochs, stats.tsv and the metrics' records equal the uninterrupted run's."""
    cfg_a, _ = _run(corpus, tmp_path, "a")
    cfg_b, ret = _run(corpus, tmp_path, "b", max_steps=3, save_every_n_steps=2)
    assert os.path.basename(ret) == "checkpoint_0_step_2"
    assert os.path.isdir(os.path.join(cfg_b.save, "checkpoint_0_step_1"))  # periodic
    assert not os.path.isdir(os.path.join(cfg_b.save, "checkpoint_0"))
    mid = checkpoint.read_meta(ret)["mid"]
    assert mid.pop("id_flyp_loss_sum") > 0
    assert mid == {"step_in_epoch": 2, "data_pass": 0, "batch_in_pass": 3, "proportion": -1.0}
    _, ret = _run(corpus, tmp_path, "b", max_steps=3)
    assert os.path.basename(ret) == "checkpoint_1_step_1"
    assert not os.path.isdir(os.path.join(cfg_b.save, "checkpoint_0_step_1"))  # pruned
    _, ret = _run(corpus, tmp_path, "b")
    assert os.path.basename(ret) == "checkpoint_1"
    for epoch in (0, 1):
        _assert_checkpoints_equal(os.path.join(cfg_a.save, f"checkpoint_{epoch}"),
                                  os.path.join(cfg_b.save, f"checkpoint_{epoch}"))
    assert _text(os.path.join(cfg_a.log_dir, "stats.tsv")) == _text(os.path.join(cfg_b.log_dir, "stats.tsv"))
    for epoch in (0, 1):
        name = f"class_stats{epoch}.tsv"
        assert _text(os.path.join(cfg_a.log_dir, name)) == _text(os.path.join(cfg_b.log_dir, name))

    def records(log_dir):
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            return [{k: v for k, v in r.items() if k != "ts"} for r in map(json.loads, f)]

    assert records(cfg_a.log_dir) == records(cfg_b.log_dir)


def rn_port_model():
    """``tests/test_flyp_trainer.py::tiny_resnet`` in the port: a BatchNorm
    image tower, its running statistics from the JAX init."""
    jmodel, variables = tiny_resnet()
    host = jax.tree_util.tree_map(np.asarray, variables)
    model = CLIPModel(port_config(jmodel.config))
    model.load_state_dict(convert.from_jax_params(host["params"], host["batch_stats"]), strict=True)
    return model


def test_resnet_chunked_resume_is_bitwise_exact(corpus, tmp_path):  # noqa: F811
    """A ModifiedResNet trained with the chunked step (2 chunks of 4),
    stopped in mid-epoch and resumed: its checkpoints, running statistics
    included, and stats.tsv equal the uninterrupted run's."""
    flags = dict(curriculum=True, grad_cache_chunks=2)
    cfg_a = port_cfg(corpus, tmp_path, "rn_a", **flags)
    flyp.flyp_train(cfg_a, model=rn_port_model(), print_every=2)
    cfg_b = port_cfg(corpus, tmp_path, "rn_b", max_steps=3, save_every_n_steps=2, **flags)
    ret = flyp.flyp_train(cfg_b, model=rn_port_model(), print_every=2)
    assert os.path.basename(ret) == "checkpoint_0_step_2"
    cfg_b = port_cfg(corpus, tmp_path, "rn_b", **flags)
    assert os.path.basename(flyp.flyp_train(cfg_b, model=rn_port_model(), print_every=2)) == "checkpoint_1"
    for epoch in (0, 1):
        a = os.path.join(cfg_a.save, f"checkpoint_{epoch}")
        _assert_checkpoints_equal(a, os.path.join(cfg_b.save, f"checkpoint_{epoch}"))
    stats = checkpoint.load_tensors(a, "batch_stats.pt")
    fresh = dict(rn_port_model().named_buffers())
    assert sorted(stats) == sorted(fresh) and not torch.equal(stats["visual.bn1.mean"], fresh["visual.bn1.mean"])
    assert _text(os.path.join(cfg_a.log_dir, "stats.tsv")) == _text(os.path.join(cfg_b.log_dir, "stats.tsv"))


def test_curriculum_midpass_resume_exact(corpus, tmp_path):  # noqa: F811
    """Stopped one batch into the guidance-100 pass: the resume rebuilds
    that loader without logging its "Image Guidance" row again."""
    base = dict(curriculum=True, epochs=1)
    cfg_a, _ = _run(corpus, tmp_path, "ca", **base)
    cfg_b, ret = _run(corpus, tmp_path, "cb", max_steps=3, **base)
    assert os.path.basename(ret) == "checkpoint_0_step_2"
    assert checkpoint.read_meta(ret)["cursor"] == {"epoch": 0, "cur_guidance": 100, "cur_str_times": 1,
                                                   "cur_guidance_id": 1}
    _run(corpus, tmp_path, "cb", **base)
    assert _guidance_rows(cfg_b.log_dir) == _guidance_rows(cfg_a.log_dir) == [(0, 2), (0, 100)]
    _assert_checkpoints_equal(os.path.join(cfg_a.save, "checkpoint_0"), os.path.join(cfg_b.save, "checkpoint_0"))
    assert _text(os.path.join(cfg_a.log_dir, "stats.tsv")) == _text(os.path.join(cfg_b.log_dir, "stats.tsv"))


def test_progress_step_checkpoint_resume_exact(corpus, tmp_path):  # noqa: F811
    """--progress with exploration: the host state (last_perform, the
    exploration RNG, the moving averages) rides the step checkpoint, so the
    resumed run makes the uninterrupted run's guidance choices."""
    base = dict(curriculum=True, progress=True, explore=True, epochs=2)
    cfg_a, _ = _run(corpus, tmp_path, "pa", **base)
    cfg_b, ret = _run(corpus, tmp_path, "pb", max_steps=5, **base)
    assert "_step_" in os.path.basename(ret)
    host = checkpoint.restore_checkpoint(ret, flyp.create_train_state(
        port_model(), flyp.make_optimizer(lambda c: c * 0.0, 0.1)), mid=True, host=True)[-1]
    assert host["last_perform"] and set(host) == {"last_perform", "explore_rng", "loss_pairs", "progress_ma"}
    _run(corpus, tmp_path, "pb", **base)
    assert _guidance_rows(cfg_a.log_dir) == _guidance_rows(cfg_b.log_dir)
    assert len(_guidance_rows(cfg_a.log_dir)) >= 3
    for epoch in (0, 1):
        _assert_checkpoints_equal(os.path.join(cfg_a.save, f"checkpoint_{epoch}"),
                                  os.path.join(cfg_b.save, f"checkpoint_{epoch}"))
    assert _text(os.path.join(cfg_a.log_dir, "stats.tsv")) == _text(os.path.join(cfg_b.log_dir, "stats.tsv"))


@pytest.mark.parametrize("flags, match", [
    (dict(save_every_n_steps=2, data_backend="tfdata"), "need the threads/native CSV backends"),
    (dict(max_steps=2, ft_data="shard-{00..01}.tar"), "webdataset streams are unsupported"),
    (dict(max_steps=2, data_backend="grain"), "--data_backend grain is not ported"),
])
def test_step_checkpoints_reject_streaming_backends(corpus, tmp_path, flags, match):  # noqa: F811
    cfg = port_cfg(corpus, tmp_path, "refused", **flags)
    with pytest.raises(ValueError, match=match):
        flyp.flyp_train(cfg, model=port_model())
    assert not os.path.exists(cfg.save)


def test_profile_dir_writes_trace(corpus, tmp_path):  # noqa: F811
    """A window of steps is traced, also when --max_steps exits inside it,
    and when the trainer raises (the non-finite-loss guard) inside it."""
    prof = tmp_path / "trace"
    cfg, _ = _run(corpus, tmp_path, "prof", profile_dir=str(prof), profile_start_step=1, profile_steps=2,
                  max_steps=2)
    traces = glob.glob(str(prof / "trace_*.json"))
    assert len(traces) == 1 and '"traceEvents"' in _text(traces[0])
    assert all(f'"{name}"' in _text(traces[0]) for name in ("step", "step.forward", "step.backward", "step.update"))

    model = port_model()
    with torch.no_grad():
        model.logit_scale.fill_(float("nan"))
    prof = tmp_path / "trace_raise"
    cfg = port_cfg(corpus, tmp_path, "prof_raise", profile_dir=str(prof), profile_start_step=0, profile_steps=50)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        flyp.flyp_train(cfg, model=model, print_every=1)
    assert len(glob.glob(str(prof / "trace_*.json"))) == 1
    from torch.profiler import profile  # a leaked profiler would refuse to start

    with profile():
        pass


def test_trace_and_step_timer(tmp_path):
    from flyp_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "t")):
        torch.ones(8) @ torch.ones(8)
    assert len(glob.glob(str(tmp_path / "t" / "trace_*.json"))) == 1
