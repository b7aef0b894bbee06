"""The port's few-shot trainer (``flyp_tpu_torch/training/few_shot.py``, its
driver and ``cli/few_shot.py``) against the JAX package's.

Both start from one tiny CLIP (``tests/test_research_trainers.py``'s ViT and
``tests/test_flyp_trainer.py``'s RN, the JAX weights crossing by
``from_jax_params``) on the research corpus, k = 4, fp32.  Every validation
scoring of a run (one before training and one after each epoch, then the
re-score of the kept snapshot) is recorded on both sides: accuracies equal,
cross-entropies within 1e-5 (a few fp32 roundings of sums taken in another
order, after Adam steps of 1e-3 whose first moves are sign-like); the test
accuracies equal, and ``stats_final.txt`` equal line for line.  On the RN,
whose training-mode BatchNorm amplifies rounding (ROADMAP, "What the parity
tests showed"), a score after training steps is held to 1e-3 of its value,
the bound the RN's running statistics are held to after Adam steps
(``tests/test_torch_resnet.py``); the untrained score keeps 1e-5.
"""

import os

import pytest
import torch

from flyp_tpu.evaluation import evaluator as jax_evaluator
from flyp_tpu.training import few_shot as jax_few_shot
from flyp_tpu.utils.logging import get_logger
from flyp_tpu_torch.cli import few_shot as cli_few_shot
from flyp_tpu_torch.cli import main as cli_main
from flyp_tpu_torch.evaluation import evaluator
from flyp_tpu_torch.training import few_shot
from tests.test_flyp_trainer import tiny_resnet
from tests.test_research_trainers import corpus, make_cfg, tiny_model  # noqa: F401
from tests.torch_research_helpers import port_cfg, port_model

torch.set_num_threads(1)
LOSS_TOL = 1e-5
RN_TRAINED_REL_TOL = 1e-3


def _recording(monkeypatch, module, real, out):
    def record(*args, **kwargs):
        res = real(*args, **kwargs)
        out.append(res)
        return res

    monkeypatch.setattr(module, "eval_single_batch", record)


def _assert_scores_match(got, want, trained_rel_tol=None):
    """Scores in order; ``trained_rel_tol`` bounds those after the first
    (the untrained model's) relative to JAX's instead of ``LOSS_TOL``."""
    assert len(got) == len(want) > 0
    for i, ((acc, loss), (jacc, jloss)) in enumerate(zip(got, want)):
        assert acc == jacc
        tol = LOSS_TOL if i == 0 or trained_rel_tol is None else trained_rel_tol * abs(jloss)
        assert abs(loss - jloss) <= tol, (i, loss, jloss)


@pytest.mark.parametrize("tower", ["vit", "rn"])
def test_few_shot_matches_jax(monkeypatch, corpus, tmp_path, tower):  # noqa: F811
    """One run of 2 epochs: every validation score, the kept snapshot's
    re-score (BatchNorm statistics carried on the RN) and the test top-1."""
    make = tiny_model if tower == "vit" else tiny_resnet
    jscores, scores = [], []
    _recording(monkeypatch, jax_few_shot, jax_evaluator.eval_single_batch, jscores)
    _recording(monkeypatch, few_shot, evaluator.eval_single_batch, scores)
    jmodel, variables = make()
    want = jax_few_shot.flyp_few_shot(make_cfg(corpus, tmp_path, k=4, epochs=2), get_logger(None), model=jmodel,
                                      variables=variables)
    got = few_shot.flyp_few_shot(port_cfg(corpus, tmp_path, k=4, epochs=2), get_logger(None),
                                 model=port_model(jmodel, variables))
    _assert_scores_match(scores, jscores, RN_TRAINED_REL_TOL if tower == "rn" else None)
    assert scores[-1] in scores[:-1]  # the re-score reproduces the kept one
    assert len(scores) == 2 + 2  # before training, after each epoch, the re-score
    assert got == want


def test_few_shot_driver_matches_jax(monkeypatch, corpus, tmp_path):  # noqa: F811
    """Two restarts of one epoch each through ``few_shot_driver``:
    ``stats_final.txt`` equal to JAX's."""
    jscores, scores = [], []
    _recording(monkeypatch, jax_few_shot, jax_evaluator.eval_single_batch, jscores)
    _recording(monkeypatch, few_shot, evaluator.eval_single_batch, scores)
    jcfg = make_cfg(corpus, tmp_path, k=4, epochs=1, log_dir=str(tmp_path / "jax"))
    want = jax_few_shot.few_shot_driver(jcfg, get_logger(None), num_runs=2, model_factory=lambda: tiny_model(1))
    cfg = port_cfg(corpus, tmp_path, k=4, epochs=1, log_dir=str(tmp_path / "port"))
    got = few_shot.few_shot_driver(cfg, get_logger(None), num_runs=2,
                                   model_factory=lambda: port_model(*tiny_model(1)))
    _assert_scores_match(scores, jscores)
    assert got == want and set(got) == {"Val", "Test", "ValDev", "TestDev"}
    with open(os.path.join(jcfg.log_dir, "stats_final.txt")) as f, \
            open(os.path.join(cfg.log_dir, "stats_final.txt")) as g:
        assert g.read() == f.read()


def test_cli_few_shot_run_directories(monkeypatch, corpus, tmp_path):  # noqa: F811
    """``python -m flyp_tpu_torch.cli.few_shot``: the trainer's flags plus
    ``--device``, models under ``<save>/<exp>/<run key>``, the log and
    ``stats_final.txt`` under ``expt_logs/<exp>/<run key>``."""
    from flyp_tpu_torch.models import factory

    monkeypatch.chdir(tmp_path)
    argv = ["--k", "4", "--epochs", "1", "--train-dataset", "PatchCamelyonVal", "--template",
            "patchcamelyon_template", "--eval-datasets", "PatchCamelyonVal,PatchCamelyonTest", "--data-location",
            corpus["root"], "--ft_data", corpus["train_csv"], "--batch-size", "4", "--workers", "2",
            "--compute_dtype", "float32", "--save", str(tmp_path / "models")]
    cfg = cli_main.parse_main_arguments(argv)
    assert cfg.device == "cuda" and cfg.k == 4
    with pytest.raises(AssertionError, match="path to store models"):
        cli_few_shot.main(cli_main.parse_main_arguments(argv[:-2]))
    tiny = port_model(*tiny_model(1)).config
    real = factory.build_clip_model
    monkeypatch.setattr(factory, "build_clip_model",
                        lambda c, device: real(c, config_override=tiny, device=device))
    summary = cli_few_shot.main(cli_main.parse_main_arguments(["--device", "cpu", *argv]), num_runs=1)
    assert set(summary) == {"Val", "Test", "ValDev", "TestDev"}
    key = cfg.run_key()
    assert os.path.isdir(tmp_path / "models" / "few_shot" / key)
    assert sorted(os.listdir(tmp_path / "expt_logs" / "few_shot" / key)) == ["log.log", "stats_final.txt"]
