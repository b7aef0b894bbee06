"""The port's serving slice against the JAX package, fp32 on the CPU.

Tokenizer, zero-shot head, ``ClipServer`` requests, ``from_checkpoint`` on a
``.pt`` written by the JAX converter, and the batch-mode CLI, all on the
same tiny CLIP weights (``__graft_entry__._tiny_config(real_text=True)``).
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flyp_tpu.cli import serve as jax_cli
from flyp_tpu.data.registry import get_classnames_for as jax_get_classnames_for
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.models.convert import export_clip_state_dict, save_torch_checkpoint
from flyp_tpu.serving import ClipServer as JaxClipServer
from flyp_tpu.templates import openai_imagenet_template_reduced as jax_template
from flyp_tpu.tokenizer import shrink_context as jax_shrink_context
from flyp_tpu.tokenizer import tokenize as jax_tokenize
from flyp_tpu_torch.cli import serve as port_cli
from flyp_tpu_torch.data import datasets as port_datasets
from flyp_tpu_torch.data.registry import get_classnames_for
from flyp_tpu_torch.models import CLIPModel, build_clip_model, convert
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.serving import ClipServer
from flyp_tpu_torch.templates import openai_imagenet_template_reduced as port_template
from flyp_tpu_torch.tokenizer import shrink_context, tokenize

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 towers: summation order differs
CLASSNAMES = ["cat", "dog", "school bus", "golden retriever", "tench"]
BUCKETS = (4, 8)

CORPUS = [
    "a photo of a cat.",
    "Café déjà vu — naïve façade",
    "北京的猫 and 東京の犬",
    "digits 0123456789 and ½ ² ³ ⁴ ٣ ४",
    "superscripts x² + y³ = z⁴",
    "emoji 🐱🐶🚌 👍🏽",
    "html &amp; entities &lt;b&gt; &quot;quoted&quot; &#39;s",
    "contractions: it's, we're, they've, I'm, you'll, he'd, don't",
    "  MIXED   Case\tWhitespace\nnewline  ",
    "ſ long s, ﬁ ligature, ＦＵＬＬ width",
    "x " * 60,
    "",
]


def port_config(cfg) -> CLIPConfig:
    d = dataclasses.asdict(cfg)
    return CLIPConfig(
        embed_dim=d["embed_dim"], vision=VisionConfig(**d["vision"]), text=TextConfig(**d["text"]),
        logit_scale_init=d["logit_scale_init"],
    )


@pytest.fixture(scope="module")
def pair():
    jcfg = _tiny_config(real_text=True)
    jmodel = JaxCLIPModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jmodel, 1))
    variables = {"params": params}
    jsrv = JaxClipServer.for_classification(jmodel, variables, CLASSNAMES, jax_template, image_buckets=BUCKETS)
    model = CLIPModel(port_config(jcfg))
    model.load_state_dict(convert.from_jax_params(params), strict=True)
    model.eval().requires_grad_(False)
    srv = ClipServer.for_classification(model, CLASSNAMES, port_template, image_buckets=BUCKETS)
    return SimpleNamespace(jcfg=jcfg, params=params, jsrv=jsrv, srv=srv)


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 64, 64, 3)).astype(np.float32)


def test_tokenize_matches_jax():
    ours, ref = tokenize(CORPUS), jax_tokenize(CORPUS)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tokenize(CORPUS, context_length=16), jax_tokenize(CORPUS, context_length=16))
    for rows in (slice(0, 3), slice(0, None), slice(4, 6)):
        np.testing.assert_array_equal(shrink_context(ours[rows]), jax_shrink_context(ref[rows]))


def test_zeroshot_head_matches_jax(pair):
    ref = np.asarray(pair.jsrv.head.weight)
    ours = pair.srv.head.weight.numpy()
    assert ours.shape == ref.shape == (len(CLASSNAMES), pair.jcfg.embed_dim)
    np.testing.assert_allclose(ours, ref, **TOL)
    assert pair.srv.head.normalize


@pytest.mark.parametrize("n", [3, 5, 8, 19])
def test_requests_match_jax(pair, n):
    """Request sizes below, at and across the (4, 8) buckets; 19 splits into
    8 + 8 + a 4-bucket tail."""
    imgs = _images(n, seed=n)
    np.testing.assert_allclose(pair.srv.classify(imgs), np.asarray(pair.jsrv.classify(imgs)), **TOL)
    np.testing.assert_allclose(
        pair.srv.encode_images(imgs), np.asarray(pair.jsrv.encode_images(imgs), np.float32), **TOL
    )
    probs, idx = pair.srv.top_k(imgs, k=3)
    jprobs, jidx = pair.jsrv.top_k(imgs, k=3)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(probs, jprobs, **TOL)
    caps = (CORPUS * 2)[:n]
    np.testing.assert_allclose(pair.srv.encode_texts(caps), np.asarray(pair.jsrv.encode_texts(caps)), **TOL)


def test_stream_logits_matches_jax(pair):
    batches = [_images(n, seed=10 + n) for n in (3, 8, 5)]
    ours = list(pair.srv.stream_logits(batches))
    ref = list(pair.jsrv.stream_logits(batches))
    assert [o.shape for o in ours] == [r.shape for r in ref]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, np.asarray(r), **TOL)
    feats = np.concatenate(list(pair.srv.stream_features(batches)))
    np.testing.assert_allclose(feats, pair.srv.encode_images(np.concatenate(batches)), atol=1e-6, rtol=1e-6)


def test_similarity_and_warmup(pair):
    imgs = _images(3, seed=4)
    f_img, f_txt = pair.srv.encode_images(imgs), pair.srv.encode_texts(["a cat", "a dog"])
    np.testing.assert_allclose(
        pair.srv.similarity(f_img, f_txt), np.asarray(pair.jsrv.similarity(f_img, f_txt)), rtol=1e-6
    )
    assert pair.srv.warmup() == pair.jsrv.warmup()


def test_from_checkpoint_serves_jax_converter_pt(pair, tmp_path):
    path = str(tmp_path / "tiny.pt")
    save_torch_checkpoint(path, export_clip_state_dict(pair.params))
    srv = ClipServer.from_checkpoint(
        path, classnames=CLASSNAMES, template=port_template, compute_dtype="float32", device="cpu",
        image_buckets=BUCKETS,
    )
    assert srv.model.config == port_config(pair.jcfg)
    imgs = _images(6, seed=2)
    np.testing.assert_array_equal(srv.classify(imgs), pair.srv.classify(imgs))
    # The port's own writer round-trips through the same loader.
    own = str(tmp_path / "own.pt")
    convert.save_torch_checkpoint(own, convert.export_clip_state_dict(srv.model.state_dict(), srv.model.config))
    again = ClipServer.from_checkpoint(own, compute_dtype="float32", device="cpu", image_buckets=BUCKETS)
    np.testing.assert_array_equal(again.encode_images(imgs), srv.encode_images(imgs))


def _read_tsv(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def test_cli_tsv_matches_jax(pair, tmp_path):
    """Same checkpoint, images and flags through both CLIs.  Every column is
    equal except the printed probability, which may differ in its sixth
    decimal (fp32 logits agree to ~1e-6), so it is compared at 2e-6."""
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(5)
    for i in range(7):
        Image.fromarray(rng.integers(0, 255, (80 + 4 * i, 72, 3), dtype=np.uint8)).save(img_dir / f"im{i}.png")
    ckpt = str(tmp_path / "tiny.pt")
    save_torch_checkpoint(ckpt, export_clip_state_dict(pair.params))
    common = ["--checkpoint", ckpt, "--images", str(img_dir), "--classnames", ",".join(CLASSNAMES),
              "--top-k", "3", "--image-buckets", "4,8", "--compute-dtype", "float32"]
    assert jax_cli.main(common + ["--output", str(tmp_path / "jax.tsv")], config_override=pair.jcfg) == 0
    assert port_cli.main(common + ["--output", str(tmp_path / "port.tsv"), "--device", "cpu"],
                         config_override=port_config(pair.jcfg)) == 0
    ref, ours = _read_tsv(tmp_path / "jax.tsv"), _read_tsv(tmp_path / "port.tsv")
    assert len(ours) == len(ref) == 8
    for o, r in zip(ours, ref):
        assert o[:2] + o[3:] == r[:2] + r[3:]
        if r[2] != "prob":
            assert abs(float(o[2]) - float(r[2])) <= 2e-6


def test_cli_features_and_dataset_classnames(pair, tmp_path):
    from PIL import Image

    img = tmp_path / "a.png"
    Image.fromarray(np.full((70, 90, 3), 128, np.uint8)).save(img)
    ckpt = str(tmp_path / "tiny.pt")
    save_torch_checkpoint(ckpt, export_clip_state_dict(pair.params))
    out = str(tmp_path / "f.npz")
    port_cli.main(["--checkpoint", ckpt, "--images", str(img), "--features", out, "--device", "cpu",
                   "--compute-dtype", "float32"], config_override=port_config(pair.jcfg))
    with np.load(out) as z:
        assert z["features"].shape == (1, pair.jcfg.embed_dim)
    names = sorted(n for n, v in vars(port_datasets).items() if isinstance(v, type) and "Dataset" not in n)
    assert "ObjectNet" in names and "ImageNet16" in names
    for name in names + ["sst2Val"]:
        if name.startswith("OxfordPet"):  # its names come from the annotations on disk
            with pytest.raises(KeyError, match="OxfordPet"):
                get_classnames_for(name)
            continue
        assert get_classnames_for(name) == jax_get_classnames_for(name), name


def test_entry_points_default_to_cuda(tmp_path):
    """Without ``device=`` the entry points ask for the GPU, and raise where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype="float32", seed=0)
    tiny = port_config(_tiny_config(real_text=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_clip_model(cfg, config_override=tiny)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClipServer.from_checkpoint(None, config_override=tiny)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["--checkpoint", str(tmp_path / "x.pt"), "--images", str(tmp_path), "--features", "f.npz"])
