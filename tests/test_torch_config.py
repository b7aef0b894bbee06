"""The port's parser, process grid and trainer data dispatch against the
JAX package's, on the CPU."""

import dataclasses
import shlex

import numpy as np
import pytest
import torch

from flyp_tpu import config as jax_config
from flyp_tpu.parallel import multihost as jax_multihost
from flyp_tpu_torch import config
from flyp_tpu_torch.data.csv_data import get_csv_loader
from flyp_tpu_torch.data.webdataset import WebDatasetLoader
from flyp_tpu_torch.parallel import multihost
from flyp_tpu_torch.training.data import check_resumable, device_iter, train_loader
from tests.test_cli_parity import README_COMMANDS

torch.set_num_threads(1)

SAMPLES = ["a,b", "x", "1", "0.5", "ImageNet,ImageNetV2"]


def describe(action):
    """What an argparse action does, comparable across the two parsers."""
    kind = type(action).__name__
    typed = None
    if action.type is not None:
        typed = []
        for s in SAMPLES:
            try:
                typed.append(action.type(s))
            except ValueError:
                typed.append("ValueError")
    return (tuple(action.option_strings), action.dest, action.default, action.choices, action.nargs,
            action.const, action.required, kind, typed)


def test_parser_matches_jax():
    ours = config.build_parser()._actions
    ref = jax_config.build_parser()._actions
    assert [describe(a) for a in ours] == [describe(a) for a in ref]
    assert len(ours) == 80


def test_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(config.ExperimentConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_config.ExperimentConfig)}
    assert ours.keys() == ref.keys()
    assert ours.pop("device") == "cuda" and ref.pop("device") == "tpu"
    assert ours == ref
    assert config.ExperimentConfig().run_key() == jax_config.ExperimentConfig().run_key()


@pytest.mark.parametrize("command", README_COMMANDS + [
    "--ft_data x.tsv --data_backend native --workers 6 --batch-size 256 --no-debug --curriculum --load a,b",
    "--ft_data s-{00..02}.tar --train-num-samples 512 --dataset-type webdataset --fsdp --alpha 0.1 0.2",
], ids=lambda c: c.split("=", 2)[1].split(" ")[0] if "=" in c else c.split()[1])
def test_reference_commands_parse_to_equal_configs(command):
    ours = dataclasses.asdict(config.parse_arguments(shlex.split(command)))
    ref = dataclasses.asdict(jax_config.parse_arguments(shlex.split(command)))
    assert ours.pop("device") == "cuda"
    ref.pop("device")
    assert ours == ref


def test_bad_choice_is_refused_as_jax():
    for parse in (config.parse_arguments, jax_config.parse_arguments):
        with pytest.raises(SystemExit):
            parse(["--data_backend", "dali"])


@pytest.mark.parametrize("args", [(None, None, True), (1, 4, True), (None, 3, True), (2, 4, False),
                                  (None, None, False), (0, 1, True)])
def test_resolve_process_matches_jax(args):
    assert multihost.resolve_process(*args) == jax_multihost.resolve_process(*args)


def test_process_grid_matches_jax():
    assert multihost.input_shard_grid() == jax_multihost.input_shard_grid() == (0, 1)
    assert multihost.process_index() == jax_multihost.process_index() == 0
    assert multihost.process_count() == jax_multihost.process_count() == 1
    assert multihost.is_primary() and jax_multihost.is_primary()
    assert multihost.local_batch_size(256) == jax_multihost.local_batch_size(256) == 256
    with pytest.raises(ValueError):
        multihost.resolve_process(1, None)
    with pytest.raises(ValueError):
        jax_multihost.resolve_process(1, None)


def test_local_batch_size_refuses_uneven_split(monkeypatch):
    monkeypatch.setattr(multihost, "input_shard_grid", lambda: (0, 3))
    assert multihost.local_batch_size(12) == 4
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_size(256)


# ------------------------------------------------ the trainer's dispatch ----

@pytest.fixture
def tsv(tmp_path):
    from PIL import Image

    rows = ["title\tfilepath\tlabel\tguidance\timg_id"]
    for i in range(12):
        path = tmp_path / f"i{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(path)
        rows.append(f"caption {i}\t{path}\t{i % 3}\t{(100, 50)[i % 2]}\t{i}")
    path = tmp_path / "train.tsv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.mark.parametrize("backend", ["tfdata", "grain"])
def test_refused_backends_raise_by_name(tsv, backend):
    cfg = config.parse_arguments(["--ft_data", tsv, "--data_backend", backend])
    with pytest.raises(ValueError, match=f"--data_backend {backend} is not ported.*threads and native"):
        train_loader(cfg, 16)


def test_train_loader_dispatch(tsv, tmp_path):
    cfg = config.parse_arguments(["--ft_data", tsv, "--batch-size", "4", "--data_backend", "native",
                                  "--workers", "1"])
    loader = train_loader(cfg, 16, guidance=50, proportion=0.25, list_classes=[0, 1], return_img_id=True)
    ref = get_csv_loader(cfg, True, 16, guidance=50, ori_proportion=0.25, list_selection=[0, 1],
                         return_img_id=True)
    assert loader.dataset.captions == ref.dataset.captions and loader.dataset.img_id == ref.dataset.img_id
    assert len(loader) == len(ref) > 0
    wds_cfg = config.parse_arguments(["--ft_data", str(tmp_path / "s-{0..1}.tar"), "--train-num-samples", "8",
                                      "--batch-size", "4", "--data_backend", "tfdata"])
    assert isinstance(train_loader(wds_cfg, 16), WebDatasetLoader)  # tar shards before the backend, as in JAX


@pytest.mark.parametrize("compute_dtype,image_dtype", [("bfloat16", torch.bfloat16), ("float32", torch.float32)])
def test_device_iter_casts_by_compute_dtype(tsv, compute_dtype, image_dtype):
    cfg = config.parse_arguments(["--ft_data", tsv, "--batch-size", "4", "--data_backend", "native",
                                  "--workers", "1"])
    batches = list(device_iter(train_loader(cfg, 16), "cpu", compute_dtype))
    assert len(batches) == 3
    assert all(b["image"].dtype == image_dtype and b["image"].shape == (4, 16, 16, 3) for b in batches)
    assert all(b["tokens"].dtype == torch.int32 and b["tokens"].shape == (4, 16) for b in batches)


@pytest.mark.parametrize("flags,refused", [
    (["--save_every_n_steps", "10", "--data_backend", "tfdata"], True),
    (["--max_steps", "5", "--ft_data", "s-{0..3}.tar"], True),
    (["--max_steps", "5", "--ft_data", "x.csv", "--dataset-type", "webdataset"], True),
    (["--save_every_n_steps", "10", "--data_backend", "grain"], False),
    (["--save_every_n_steps", "10", "--data_backend", "native"], False),
    (["--ft_data", "s-{0..3}.tar"], False),
])
def test_check_resumable(flags, refused):
    if "--ft_data" not in flags:
        flags = [*flags, "--ft_data", "x.tsv"]
    cfg = config.parse_arguments(flags)
    if refused:
        with pytest.raises(ValueError, match="deterministic mid-epoch fast-forward"):
            check_resumable(cfg)
    else:
        check_resumable(cfg)


def test_check_resumable_names_the_ported_backends():
    """``grain`` is refused by ``train_loader``, so the message names only
    the backends that resume."""
    cfg = config.parse_arguments(["--max_steps", "5", "--ft_data", "x.tsv", "--data_backend", "tfdata"])
    with pytest.raises(ValueError) as err:
        check_resumable(cfg)
    assert "need the threads/native CSV backends" in str(err.value) and "grain" not in str(err.value)
