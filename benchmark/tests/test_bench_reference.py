"""The plain reference against the program's plain route on the CPU at a
tiny size, in float32: the same weights and inputs give the same features,
loss, gradients, AdamW steps and zero-shot logits."""

import pytest
import torch

from benchmark import inputs, program, weights
from benchmark.reference import clip as ref
from benchmark.yardstick import compare

from conftest import tiny_config

CPU = torch.device("cpu")
MIX = {"batch": 6, "distinct_batches": 3, "caption_tokens": [6, 20], "vocab_ids": [1, 49000],
       "optimizer": {"lr": 1e-4, "weight_decay": 0.1, "warmup": 0, "total_steps": 100}}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    cfg = tiny_config("float32")
    batches = inputs.train_batches(cfg, MIX, 11, CPU, torch.float32)
    return cfg, batches


def test_towers_and_loss_match(setup):
    cfg, batches = setup
    images, tokens = batches[0]
    m = program.model(cfg, weights.make(cfg, 11, CPU), CPU)
    w = weights.make(cfg, 11, CPU)
    with torch.no_grad():
        img_p, txt_p, scale = m(images, program.shrink(tokens))
        img_r = ref.normalize(ref.encode_image(w, images, cfg))
        txt_r = ref.normalize(ref.encode_text(w, tokens, cfg))
    torch.testing.assert_close(img_p, img_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(txt_p, txt_r, rtol=1e-5, atol=1e-5)
    from flyp_tpu_torch.ops.losses import clip_loss

    loss_p = clip_loss(img_p, txt_p, scale).mean()
    torch.testing.assert_close(loss_p, ref.contrastive_loss(img_r, txt_r, w["logit_scale"]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rows", [6, 4])
def test_gradients_match_in_blocks_of_rows(setup, rows):
    """The reference's gradient, worked out ``rows`` rows at a time, is the
    program's autograd gradient of the whole batch."""
    cfg, batches = setup
    images, tokens = batches[0]
    m = program.model(cfg, weights.make(cfg, 11, CPU), CPU).train().requires_grad_(True)
    from flyp_tpu_torch.ops.losses import clip_loss

    loss = clip_loss(*m(images, program.shrink(tokens))).mean()
    grads = dict(zip([n for n, _ in m.named_parameters()], torch.autograd.grad(loss, list(m.parameters()))))
    loss_r, grads_r = ref.loss_and_grads(weights.make(cfg, 11, CPU), images, tokens, cfg, rows=rows)
    torch.testing.assert_close(loss, loss_r, rtol=1e-6, atol=1e-6)
    for n, g in grads.items():  # float32 round-off, summed in other orders
        assert float((g - grads_r[n]).norm()) <= 1e-4 * float(grads_r[n].norm()) + 1e-7, n


def test_three_steps_match(setup):
    """The program's step in float32 with float32 moments against the
    reference's three AdamW steps: losses, first gradient, change."""
    cfg, batches = setup
    cfg = dict(cfg, moment_dtype="float32")
    m = program.model(cfg, weights.make(cfg, 11, CPU), CPU)
    step, state = program.train_step(m, cfg, MIX["optimizer"])
    feed = [(im, program.shrink(tok)) for im, tok in batches]
    from benchmark.drivers.train import program_readings

    _, prog = program_readings(step, state, m, feed, 3)
    w = {k: v.clone() for k, v in weights.make(cfg, 11, CPU).items()}
    losses, grad, change = ref.train_readings(w, batches, cfg, MIX["optimizer"], rows=4)
    refr = {"losses": losses, "grad": compare.leaf_norms(grad.items()), "change": compare.leaf_norms(change.items())}
    n = compare.train_numbers(prog, refr)
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-4 and n["change_gap"] < 1e-3, n


def test_zero_shot_logits_match(setup):
    cfg, batches = setup
    images = batches[1][0]
    m = program.model(cfg, weights.make(cfg, 11, CPU), CPU)
    head = weights.head(cfg["embed_dim"], 10, 11, CPU)
    srv = program.server(m, head, (4, 8), window=2)
    got = torch.from_numpy(srv.classify(images.numpy()))
    want = ref.zero_shot_logits(weights.make(cfg, 11, CPU), head, images, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_float8_control_differs(setup):
    """The control rounds every product's operands: its features move by far
    more than float32 round-off."""
    cfg, batches = setup
    images = batches[0][0]
    w = weights.make(cfg, 11, CPU)
    with torch.no_grad():
        exact = ref.encode_image(w, images, cfg)
        low = ref.encode_image(w, images, cfg, ref.Precision("float8"))
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.5
