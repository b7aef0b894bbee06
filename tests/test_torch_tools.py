"""The port's offline tools against the JAX package's, on the CPU:
``tools/validate_checkpoint.py`` (its argparse errors, its zero-shot run on
a tiny ``.pt`` written by the JAX converter, and ``activation_crosscheck``
against a stand-in reference model) and ``tools/validate_data.py`` (report
and exit codes on the iWildCam, FMoW and ObjectNet trees of
``tests/test_tools.py``).
"""

import re
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from __graft_entry__ import _tiny_config
from flyp_tpu.cli import zeroshot_eval as jax_zeroshot_eval
from flyp_tpu.config import ExperimentConfig as JaxConfig
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.models.convert import export_clip_state_dict, save_torch_checkpoint
from flyp_tpu.tools import validate_checkpoint as jax_validate_checkpoint
from flyp_tpu.tools import validate_data as jax_validate_data
from flyp_tpu_torch.cli import zeroshot_eval
from flyp_tpu_torch.config import ExperimentConfig
from flyp_tpu_torch.testing import reference_stand_in
from flyp_tpu_torch.tools import validate_checkpoint, validate_data
from tests.test_torch_eval_datasets import write_trees
from tests.test_wilds_readers import fmow_tree, iwildcam_tree  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_pt(tmp_path_factory):
    jmodel = JaxCLIPModel(_tiny_config(real_text=True))
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jmodel, 3))
    ckpt = str(tmp_path_factory.mktemp("tiny") / "tiny.pt")
    save_torch_checkpoint(ckpt, export_clip_state_dict(params))
    return ckpt


def _exit(main, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return exc.value.code, capsys.readouterr().err


def test_validate_checkpoint_argparse_errors(capsys):
    """No checkpoint at all gives JAX's message; --download_pretrained names
    the downloader the port leaves out; --crosscheck needs its reference."""
    code, err = _exit(validate_checkpoint.main, [], capsys)
    jcode, jerr = _exit(jax_validate_checkpoint.main, [], capsys)
    assert code == jcode == 2
    assert "pass --checkpoint or --download_pretrained" in err and err.splitlines()[-1] == jerr.splitlines()[-1]
    code, err = _exit(validate_checkpoint.main, ["--download_pretrained", "--model", "ViT-B/16"], capsys)
    assert code == 2 and "downloader" in err and "models/download.py" in err
    code, err = _exit(validate_checkpoint.main, ["--checkpoint", "x.pt", "--crosscheck"], capsys)
    assert code == 2 and "--reference-root" in err


def test_validate_checkpoint_runs_zeroshot_eval(tiny_pt, tmp_path, monkeypatch, capsys):
    """The tool's stats are the port's ``cli/zeroshot_eval`` stats on the
    same checkpoint and flags, which are JAX's."""
    trees = write_trees(str(tmp_path / "trees"))
    monkeypatch.chdir(tmp_path)  # the evaluation's log directory
    base = dict(clip_load=tiny_pt, model="ViT-B/16", compute_dtype="float32", train_dataset="ImageNetR",
                template="simple_template", eval_datasets=["ImageNetR"], data_location=trees["main"],
                batch_size=4, workers=1)
    stats = validate_checkpoint.main(["--checkpoint", tiny_pt, "--model", "ViT-B/16", "--compute_dtype", "float32",
                                      "--train-dataset", "ImageNetR", "--template", "simple_template",
                                      "--eval-datasets", "ImageNetR", "--data-location", trees["main"],
                                      "--batch-size", "4", "--workers", "1", "--device", "cpu"])
    assert str(stats) in capsys.readouterr().out
    want = zeroshot_eval.main(ExperimentConfig(device="cpu", log_dir=str(tmp_path / "port"), **base))
    jwant = jax_zeroshot_eval.main(JaxConfig(log_dir=str(tmp_path / "jax"), **base))
    assert list(stats) == list(want) == list(jwant) and stats == want == jwant and len(stats) > 3


def _report(out: str) -> dict:
    return {m.group(1): float(m.group(2)) for m in re.finditer(r"^\s+(\S+): max abs diff (\S+)$", out, re.M)}


@pytest.mark.parametrize("perturb", [None, ("visual", 1), ("text", 0)])
def test_activation_crosscheck_localises_a_fault(tiny_pt, tmp_path, capsys, perturb):
    """Against a reference that computes what the port computes, every block
    and both features read 0; a weight moved in one block is reported at
    that block first, every block before it still 0."""
    (tmp_path / "clip").mkdir()
    (tmp_path / "clip" / "model.py").write_text(reference_stand_in(perturb))
    diff = validate_checkpoint.activation_crosscheck(tiny_pt, str(tmp_path), "cpu")
    report = _report(capsys.readouterr().out)
    names = [f"visual.block_{i}" for i in range(2)] + [f"text.block_{i}" for i in range(2)]
    assert list(report) == names + ["image_features", "text_features"]
    if perturb is None:
        assert diff == 0.0 and set(report.values()) == {0.0}
        return
    first = names.index(f"{perturb[0]}.block_{perturb[1]}")
    tower = perturb[0] + "."
    assert all(report[n] == 0.0 for n in names[:first]) and report[names[first]] > 1e-3, report
    assert all(report[n] == 0.0 for n in names if not n.startswith(tower))
    assert diff > 0 and report["image_features" if perturb[0] == "visual" else "text_features"] > 0


def test_activation_crosscheck_names_a_missing_reference(tiny_pt, tmp_path):
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / "clip" / "model.py"))):
        validate_checkpoint.activation_crosscheck(tiny_pt, str(tmp_path), "cpu")


@pytest.mark.parametrize("argv, device", [([], "cuda"), (["--device", "cpu"], "cpu")])
def test_validate_checkpoint_crosscheck_takes_the_device(tmp_path, monkeypatch, argv, device):
    """``--crosscheck`` runs the port's model on ``--device``, the card
    unless the caller asks for the CPU, as the evaluation does."""
    calls = []
    monkeypatch.setattr(validate_checkpoint, "activation_crosscheck", lambda *a: calls.append(a) or 0.0)
    monkeypatch.setattr(zeroshot_eval, "main", lambda cfg: calls.append(cfg.device) or {})
    validate_checkpoint.main(["--checkpoint", "x.pt", "--crosscheck", "--reference-root", str(tmp_path), *argv])
    assert calls == [("x.pt", str(tmp_path), device), device]


def test_activation_crosscheck_asks_for_the_card(tiny_pt, tmp_path):
    """Without ``--device cpu`` the crosscheck needs CUDA: it raises where
    there is none instead of running the plain path on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    (tmp_path / "clip").mkdir()
    (tmp_path / "clip" / "model.py").write_text(reference_stand_in())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate_checkpoint.main(["--checkpoint", tiny_pt, "--crosscheck", "--reference-root", str(tmp_path)])


def _both(argv, capsys):
    """(rc, stdout, stderr) of the JAX tool and of the port's, the port's
    ``flyp_tpu_torch/`` reader paths read as ``flyp_tpu/``."""
    out = []
    for main in (jax_validate_data.main, validate_data.main):
        rc = main(argv)
        got = capsys.readouterr()
        out.append((rc, *(text.replace("flyp_tpu_torch/", "flyp_tpu/") for text in (got.out, got.err))))
    return out


def test_validate_data_iwildcam_matches_jax(iwildcam_tree, tmp_path, capsys):  # noqa: F811
    jax_out, port_out = _both(["--dataset", "IWildCamOOD", "--root", iwildcam_tree, "--batch_size", "4",
                               "--probe", "3"], capsys)
    assert port_out == jax_out and port_out[0] == 0 and "OK IWildCamOOD" in port_out[1]
    assert "decode probe" in port_out[1] and "test samples" in port_out[1]
    for argv, needle in (
        (["--dataset", "IWildCamOOD", "--root", str(tmp_path / "empty")], "is not a directory"),
        (["--dataset", "NoSuchSet", "--root", iwildcam_tree], "unknown dataset"),
        (["--dataset", "IWildCamOOD", "--root", str(tmp_path)], "could not load"),
    ):
        jax_out, port_out = _both(argv, capsys)
        assert port_out == jax_out and port_out[0] == 1 and "FAIL" in port_out[2] and needle in port_out[2]
    broken = tmp_path / "broken"
    shutil.copytree(iwildcam_tree, broken)
    for v in sorted(broken.rglob("*.jpg")):  # the metadata still names every file
        v.unlink()
    jax_out, port_out = _both(["--dataset", "IWildCamOOD", "--root", str(broken)], capsys)
    assert port_out == jax_out and port_out[0] == 1 and "missing" in port_out[2]


def test_validate_data_fmow_matches_jax(fmow_tree, capsys):  # noqa: F811
    jax_out, port_out = _both(["--dataset", "FMOWOOD", "--root", fmow_tree, "--batch_size", "4", "--probe", "2"],
                              capsys)
    assert port_out == jax_out and port_out[0] == 0 and "OK FMOWOOD" in port_out[1]


def test_validate_data_objectnet_matches_jax(tmp_path, capsys):
    from flyp_tpu_torch.data.datasets.objectnet import get_metadata

    _, _, folder_to_ids, _ = get_metadata()
    for f in sorted(folder_to_ids.keys())[:3]:
        d = tmp_path / "objectnet-1.0" / "images" / f
        d.mkdir(parents=True)
        Image.fromarray(np.zeros((36, 36, 3), np.uint8)).save(d / "img0.png")
    jax_out, port_out = _both(["--dataset", "ObjectNet", "--root", str(tmp_path), "--probe", "2"], capsys)
    assert port_out == jax_out and port_out[0] == 0
    assert "OK ObjectNet" in port_out[1] and "classes:         113" in port_out[1]
