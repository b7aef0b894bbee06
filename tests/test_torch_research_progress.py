"""The port's progress-validation beam search (``flyp_tpu_torch/training/
progress.py``) against the JAX package's.

Beam 1, one round, on the research corpus (guidance 2 and 100, batch 4),
from one tiny CLIP of each tower: the surviving snapshot's name, its
sidecar (``last_perform`` and the step), and every TSV the round writes
(the progress before and after each guidance, the stats after each) by
name, index and columns; accuracies and progress values (differences of
accuracies over 16 images) within one image (1/16) of JAX's, the loss
column within 5e-2 (one pass of Adam's sign-like steps at 1e-3; the
trainer test's bound).  The snapshot holds the state that restores: its
parameters and BatchNorm statistics equal the kept candidate's, its
moments and count are the trained ones, and a restore gives the same
``progress_eval``.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from flyp_tpu.training import progress as jax_progress
from flyp_tpu.utils.logging import get_logger
from flyp_tpu_torch.training import flyp, progress
from flyp_tpu_torch.training.train_state import create_train_state, make_optimizer
from flyp_tpu_torch.training.schedules import make_scheduler
from tests.test_flyp_trainer import tiny_resnet
from tests.test_research_trainers import corpus, make_cfg, tiny_model  # noqa: F401
from tests.torch_research_helpers import host, port_cfg, port_model

torch.set_num_threads(1)
ONE_IMAGE = 1 / 16 + 1e-9


def _fields(tmp_path, name):
    return dict(curriculum=True, save=str(tmp_path / name / "snaps"), eval_datasets=["PatchCamelyonVal"], epochs=1,
                log_dir=str(tmp_path / name / "logs"))


def _read(path):
    return pd.read_csv(path, sep="\t", index_col=0)


@pytest.mark.parametrize("tower", ["vit", "rn"])
def test_beam_search_matches_jax(corpus, tmp_path, tower):  # noqa: F811
    jmodel, variables = (tiny_model if tower == "vit" else tiny_resnet)()
    variables = host(variables)
    kw = dict(beam_size=1, num_rounds=1, select_metric="Avg OOD Acc")
    jcfg = make_cfg(corpus, tmp_path, **_fields(tmp_path, "jax"))
    jbeam = jax_progress.flyp_progress_validation(jcfg, get_logger(None), model=jmodel, variables=variables, **kw)
    cfg = port_cfg(corpus, tmp_path, **_fields(tmp_path, "port"))
    model = port_model(jmodel, variables)
    beam = progress.flyp_progress_validation(cfg, get_logger(None), model=model, **kw)

    assert [os.path.basename(p) for p in beam] == [os.path.basename(p) for p in jbeam]
    assert sorted(os.listdir(cfg.save)) == sorted(os.listdir(jcfg.save))
    with open(beam[0] + ".perform.json") as f, open(jbeam[0] + ".perform.json") as g:
        meta, jmeta = json.load(f), json.load(g)
    assert meta["step"] == jmeta["step"] == 5  # one pass of a guidance's 20 rows at batch 4
    assert sorted(meta["last_perform"]) == sorted(jmeta["last_perform"])
    for k, v in jmeta["last_perform"].items():
        assert meta["last_perform"][k] == pytest.approx(v, abs=ONE_IMAGE if "Accuracy" in k or "F1" in k else 0)

    names = sorted(os.listdir(cfg.log_dir))
    assert names == sorted(os.listdir(jcfg.log_dir))
    assert sum(n.startswith("progress0_") for n in names) == 3 and sum(n.startswith("stats0_") for n in names) == 2
    for name in names:
        got, want = _read(os.path.join(cfg.log_dir, name)), _read(os.path.join(jcfg.log_dir, name))
        assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns), name
        for col in want.columns:
            if not pd.api.types.is_numeric_dtype(want[col]):
                assert got[col].tolist() == want[col].tolist(), (name, col)
                continue
            atol = 5e-2 if col == "Avg ID FLYP Loss" else ONE_IMAGE
            np.testing.assert_allclose(got[col].astype(float), want[col].astype(float), atol=atol, rtol=0,
                                       err_msg=f"{name} {col}")

    # The model holds the kept candidate; its snapshot restores it whole.
    ref = flyp.progress_eval(cfg, model, {}, 0, get_logger(None))[2]
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    schedule = make_scheduler("default", cfg.lr, cfg.warmup_length, cfg.epochs, 1000, cfg.min_lr)
    state = create_train_state(model, make_optimizer(schedule, cfg.wd, cfg.adam_moment_dtype))
    state, last_perform, step = progress._restore(beam[0], state)
    assert all(torch.equal(v, kept[k]) for k, v in model.state_dict().items())
    assert step == 5 and int(state.opt_state.count) == 5 and state.opt_state.mu[0].any()
    assert last_perform == meta["last_perform"]
    assert flyp.progress_eval(cfg, model, {}, 0, get_logger(None))[2] == ref
