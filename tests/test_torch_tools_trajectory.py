"""``convergence_check`` and ``bf16_drift`` of the port against the JAX
package's tools (``tools/tpu_convergence_check.py``, ``tools/bf16_drift.py``)
on the same init, in fp32 on the CPU.

Both tools train the JAX tools' tiny CLIP (``bf16_drift.tool_config``).
The init is the port's seed-0 draw, written in the OpenAI layout by the
port's converter and read by JAX's (``flyp_tpu/models/convert.py::
convert_clip_state_dict``; JAX's own init of this model takes ~15 s on one
CPU thread); both JAX tools are handed those params in place of their
``init_clip_params(model, 0)``, and they cross back to the port through
``models/convert.py::from_jax_params``.  Losses are held at the trajectory
bounds of ``tests/test_torch_train_step.py`` (rtol 1e-6 at the first step,
1e-4 after; the JAX convergence tool prints four decimals, so its losses
are held within half of its last digit on top), retrieval accuracy exactly.
"""

import contextlib
import io
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import flyp_tpu.models as jax_models
from flyp_tpu.models.convert import convert_clip_state_dict as jax_convert_clip_state_dict
from flyp_tpu_torch.models import build_clip_model, convert
from flyp_tpu_torch.tools import bf16_drift, convergence_check

torch.set_num_threads(1)

STEPS, BATCH, POOL = 3, 8, 16  # POOL > BATCH: the drift leg samples its batches


def _rtol(step):
    return 1e-6 if step == 0 else 1e-4


@pytest.fixture(scope="module")
def runs():
    from tools import bf16_drift as jax_bf16_drift
    from tools import tpu_convergence_check as jax_convergence_check

    model = build_clip_model(SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="float32", seed=0),
                             config_override=bf16_drift.tool_config(), device="cpu")
    openai = {k: v.numpy() for k, v in convert.export_clip_state_dict(model.state_dict(), model.config).items()}
    params, _, _ = jax_convert_clip_state_dict(openai)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_models, "init_clip_params", lambda model, rng=0, image_batch=1: params)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jax_convergence_check.main(STEPS, BATCH)
        conv = [(int(i), float(v)) for i, v in re.findall(r"^step (\d+): loss ([\d.]+)$", buf.getvalue(), re.M)]
        drift = jax_bf16_drift.run_leg("float32", STEPS, BATCH, POOL, every=1)
    state_dict = convert.from_jax_params(params)
    assert all(torch.equal(state_dict[k], v) for k, v in model.state_dict().items())  # the round trip is exact
    return SimpleNamespace(conv=conv, drift=drift, state_dict=state_dict)


def test_convergence_check_matches_jax(runs, capsys):
    got = convergence_check.main(STEPS, BATCH, device="cpu", state_dict=runs.state_dict)
    out = capsys.readouterr().out
    assert "CONVERGENCE OK" in out and got["plain_losses"] is None  # the CPU runs one route
    assert [i for i, _ in got["losses"]] == [i for i, _ in runs.conv] == [0, STEPS - 1]
    for (i, loss), (_, want) in zip(got["losses"], runs.conv):
        assert abs(loss - want) <= 5e-5 + _rtol(i) * abs(want), (i, loss, want)


def test_bf16_drift_matches_jax(runs):
    curve, acc = bf16_drift.run_leg("float32", STEPS, BATCH, POOL, every=1, device="cpu", state_dict=runs.state_dict)
    want_curve, want_acc = runs.drift
    assert sorted(curve) == sorted(want_curve) == list(range(STEPS))
    for i in curve:
        np.testing.assert_allclose(curve[i], want_curve[i], rtol=_rtol(i), err_msg=f"step {i}")
    assert acc == want_acc


DRIFT_KEYS = {"metric", "final_loss_fp32", "final_loss_bf16", "final_abs_divergence", "max_abs_divergence",
              "max_divergence_step", "retrieval_acc_fp32", "retrieval_acc_bf16", "acc_delta"}


def test_bf16_drift_main_runs_both_legs_on_the_plain_route(runs, monkeypatch):
    from flyp_tpu_torch.ops import attention

    seen = []
    leg = bf16_drift.run_leg

    def spy(*args, **kwargs):
        seen.append(attention._default_impl())
        return leg(*args, **kwargs)

    monkeypatch.setattr(bf16_drift, "run_leg", spy)
    monkeypatch.delenv(attention._IMPL_ENV, raising=False)
    attention._default_impl.cache_clear()
    out = bf16_drift.main(STEPS, BATCH, POOL, device="cpu", state_dict=runs.state_dict)
    assert seen == ["xla", "xla"] and attention._default_impl() == "pallas_block"
    attention._default_impl.cache_clear()
    assert set(out) == DRIFT_KEYS
    src = open("tools/bf16_drift.py").read()
    assert all(f'"{k}"' in src for k in DRIFT_KEYS)
    np.testing.assert_allclose(out["final_loss_fp32"], runs.drift[0][STEPS - 1], atol=1e-5)
    assert out["max_abs_divergence"] >= out["final_abs_divergence"] >= 0
