"""The port's HTTP front-end (``flyp_tpu_torch/serving/http.py``) and the
``--http`` mode of its serve CLI, against the JAX package's, fp32 on the CPU.

One JAX server and one port server over the same tiny CLIP weights
(``__graft_entry__._tiny_config(real_text=True)``, carried across with
``convert.from_jax_params``) and zero-shot heads over the same class names
are bound once for the module on ephemeral ports; every request goes to
both.  Status codes and keys are equal, values within the port's fp32
serving tolerance, indices and class names equal; the port's answers are
also bit-equal to its own direct ``ClipServer`` calls (float32 ->
``tolist()`` -> JSON is exact).  Where the port differs on purpose (a
server fault is 500, not 400), the test says so.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flyp_tpu.cli import serve as jax_cli
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.models.convert import export_clip_state_dict, save_torch_checkpoint
from flyp_tpu.serving import ClipServer as JaxClipServer
from flyp_tpu.serving import serve_http as jax_serve_http
from flyp_tpu.templates import simple_template as jax_template
from flyp_tpu_torch import serving as port_serving
from flyp_tpu_torch.cli import serve as port_cli
from flyp_tpu_torch.models import CLIPModel, convert
from flyp_tpu_torch.serving import ClipServer, serve_http
from flyp_tpu_torch.templates import simple_template as port_template
from tests.test_torch_serving import port_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_torch_serving.py's fp32 serving tolerance
CLASSNAMES = [f"class {i}" for i in range(6)]
BUCKETS = (4, 8)


def _bind(srv, classnames=None, bind=serve_http):
    httpd = bind(srv, 0, classnames=classnames)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _call(port, path, body=None, ctype="application/json"):
    """(status, decoded JSON) of a GET (no body) or POST."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={} if body is None else {"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _images(n, seed=0, px=64):
    return np.random.default_rng(seed).standard_normal((n, px, px, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def servers():
    jcfg = _tiny_config(real_text=True)
    jmodel = JaxCLIPModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jmodel, 2))
    variables = {"params": params}
    jsrv = JaxClipServer.for_classification(jmodel, variables, CLASSNAMES, jax_template, image_buckets=BUCKETS)
    model = CLIPModel(port_config(jcfg))
    model.load_state_dict(convert.from_jax_params(params), strict=True)
    model.eval().requires_grad_(False)
    srv = ClipServer.for_classification(model, CLASSNAMES, port_template, image_buckets=BUCKETS)
    bound = [_bind(jsrv, CLASSNAMES, jax_serve_http), _bind(srv, CLASSNAMES),
             _bind(JaxClipServer(jmodel, variables, image_buckets=(4,)), bind=jax_serve_http),
             _bind(ClipServer(model, image_buckets=(4,)))]
    yield SimpleNamespace(jcfg=jcfg, params=params, jsrv=jsrv, srv=srv, model=model,
                          jax=bound[0].server_address[1], port=bound[1].server_address[1],
                          jax_headless=bound[2].server_address[1], port_headless=bound[3].server_address[1])
    for httpd in bound:
        httpd.shutdown()
        httpd.server_close()


def _both(s, path, body=None, ctype="application/json", headless=False):
    jport, pport = (s.jax_headless, s.port_headless) if headless else (s.jax, s.port)
    (jcode, jout), (pcode, pout) = _call(jport, path, body, ctype), _call(pport, path, body, ctype)
    assert pcode == jcode, (path, jcode, jout, pcode, pout)
    assert sorted(pout) == sorted(jout), (path, jout, pout)
    return pcode, jout, pout


def test_healthz_matches_jax(servers):
    code, jout, pout = _both(servers, "/healthz")
    assert code == 200 and pout == jout
    assert pout == {"ok": True, "model": "CLIPModel", "buckets": list(BUCKETS), "num_classes": len(CLASSNAMES)}
    code, jout, pout = _both(servers, "/healthz", headless=True)
    assert code == 200 and pout == jout and pout["num_classes"] is None


def test_features_match_jax(servers):
    imgs = _images(5, seed=20)
    code, jout, pout = _both(servers, "/features", _npy(imgs), "application/x-npy")
    assert code == 200
    ours = np.asarray(pout["features"], np.float32)
    np.testing.assert_allclose(ours, np.asarray(jout["features"], np.float32), **TOL)
    np.testing.assert_array_equal(ours, servers.srv.encode_images(imgs))
    # JSON image payloads take the same path.
    code, jout, pout = _both(servers, "/features", json.dumps({"images": imgs[:2].tolist()}).encode())
    assert code == 200
    np.testing.assert_allclose(np.asarray(pout["features"]), np.asarray(jout["features"]), **TOL)
    np.testing.assert_array_equal(np.asarray(pout["features"], np.float32), servers.srv.encode_images(imgs[:2]))


def test_classify_matches_jax(servers):
    imgs = _images(5, seed=21)
    code, jout, pout = _both(servers, "/classify?k=3", _npy(imgs), "application/x-npy")
    assert code == 200 and sorted(pout) == ["classes", "indices", "probs"]
    assert pout["indices"] == jout["indices"] and pout["classes"] == jout["classes"]
    np.testing.assert_allclose(np.asarray(pout["probs"]), np.asarray(jout["probs"]), **TOL)
    probs, idx = servers.srv.top_k(imgs, k=3)
    np.testing.assert_array_equal(np.asarray(pout["probs"], np.float32), probs)
    assert pout["indices"] == idx.tolist()
    assert pout["classes"][0] == [CLASSNAMES[j] for j in idx[0]]
    code, jout, pout = _both(servers, "/classify", _npy(imgs[:1]), "application/x-npy")  # k defaults to 5
    assert code == 200 and len(pout["indices"][0]) == 5 and pout["indices"] == jout["indices"]


def test_text_features_match_jax(servers):
    texts = ["a photo", "a much longer caption about a photo of something"]
    code, jout, pout = _both(servers, "/text_features", json.dumps({"texts": texts}).encode())
    assert code == 200
    np.testing.assert_allclose(np.asarray(pout["features"]), np.asarray(jout["features"]), **TOL)
    np.testing.assert_array_equal(np.asarray(pout["features"], np.float32), servers.srv.encode_texts(texts))


@pytest.mark.parametrize("path, body, ctype", [
    ("/classify", b"not an npy body", "application/x-npy"),  # np.load refuses it
    ("/features", b"", "application/x-npy"),  # no body at all
    ("/features", b"{not json", "application/json"),
    ("/features", json.dumps({"pixels": [[0.0]]}).encode(), "application/json"),  # no "images" key
    ("/text_features", json.dumps({"captions": ["a"]}).encode(), "application/json"),  # no "texts" key
    ("/features", _npy(np.zeros((2, 32, 32, 3), np.float32)), "application/x-npy"),  # wrong size
    ("/features", _npy(np.zeros((64, 64, 3), np.float32)), "application/x-npy"),  # wrong rank
    ("/classify?k=x", _npy(np.zeros((1, 64, 64, 3), np.float32)), "application/x-npy"),
])
def test_client_errors_are_400_as_in_jax(servers, path, body, ctype):
    code, jout, pout = _both(servers, path, body, ctype)
    assert code == 400 and list(pout) == ["error"]
    assert pout["error"].split(":")[0] in ("ValueError", "KeyError", "TypeError", "EOFError", "JSONDecodeError",
                                           "UnicodeDecodeError"), pout


def test_unknown_paths_and_headless_classify(servers):
    code, jout, pout = _both(servers, "/nope", b"", "application/json")
    assert code == 404 and "error" in pout
    code, jout, pout = _both(servers, "/nope")  # GET
    assert code == 404
    code, jout, pout = _both(servers, "/classify", _npy(_images(2)), "application/x-npy", headless=True)
    assert code == 400 and "head" in pout["error"] and "head" in jout["error"]
    code, _, pout = _both(servers, "/features", _npy(_images(2)), "application/x-npy", headless=True)
    assert code == 200 and len(pout["features"]) == 2


def test_server_fault_is_500(servers, monkeypatch, capsys):
    """A well-formed request that the server fails on gets 500 and a generic
    message (the JAX server answers 400 with the exception's text); the
    traceback goes to stderr, and the next request is served."""
    def broken(*_a, **_k):
        raise RuntimeError("planted fault")

    monkeypatch.setattr(servers.srv, "encode_images", broken)
    code, out = _call(servers.port, "/features", _npy(_images(2)), "application/x-npy")
    assert code == 500 and out == {"error": "internal server error"}
    assert "planted fault" in capsys.readouterr().err
    monkeypatch.undo()
    code, out = _call(servers.port, "/features", _npy(_images(2)), "application/x-npy")
    assert code == 200


def test_cli_http_checks_match_jax(tmp_path):
    """Batch mode without --images exits with JAX's message; under --http the
    batch-only flags are refused by name (the JAX CLI ignores them)."""
    msgs = []
    for main in (jax_cli.main, port_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["--checkpoint", str(tmp_path / "x.pt")])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "--images" in msgs[1]
    for flags, named in ((["--images", str(tmp_path)], "--images"), (["--top-k", "3"], "--top-k"),
                         (["--features", "f.npz", "--output", "o.tsv"], "--features, --output")):
        with pytest.raises(SystemExit, match=named):
            port_cli.main(["--checkpoint", str(tmp_path / "x.pt"), "--http", "0", *flags])


def test_cli_http_serves_until_interrupted(servers, tmp_path, monkeypatch):
    """``cli/serve.py --http 0``: warmup before the bind, the head built from
    --classnames, requests answered as the library server answers them;
    ``shutdown`` or ^C ends the loop, the socket is closed, and main
    returns 0."""
    ckpt = str(tmp_path / "tiny.pt")
    save_torch_checkpoint(ckpt, export_clip_state_dict(servers.params))
    events, bound = [], []
    real_warmup, real_bind = ClipServer.warmup, port_serving.serve_http

    def warmup(self, *a, **k):
        events.append("warmup")
        return real_warmup(self, *a, **k)

    def bind(*a, **k):
        events.append("bind")
        bound.append(real_bind(*a, **k))
        return bound[-1]

    monkeypatch.setattr(ClipServer, "warmup", warmup)
    monkeypatch.setattr(port_serving, "serve_http", bind)
    argv = ["--checkpoint", ckpt, "--http", "0", "--classnames", ",".join(CLASSNAMES), "--template",
            "simple_template", "--image-buckets", "4,8", "--compute-dtype", "float32", "--device", "cpu", "--warmup"]
    rc = []
    t = threading.Thread(target=lambda: rc.append(port_cli.main(argv, config_override=port_config(servers.jcfg))))
    t.start()
    for _ in range(600):
        if bound or not t.is_alive():
            break
        t.join(0.1)
    assert bound, "the CLI never bound its server"
    port = bound[0].server_address[1]
    imgs = _images(3, seed=30)
    code, out = _call(port, "/classify?k=2", _npy(imgs), "application/x-npy")
    code_lib, out_lib = _call(servers.port, "/classify?k=2", _npy(imgs), "application/x-npy")
    assert code == code_lib == 200 and out == out_lib
    bound[0].shutdown()
    t.join(60)
    assert not t.is_alive() and rc == [0] and events == ["warmup", "bind"]
    assert bound[0].socket.fileno() == -1  # server_close ran

    def interrupted(*a, **k):
        httpd = real_bind(*a, **k)
        httpd.serve_forever = lambda: (_ for _ in ()).throw(KeyboardInterrupt)
        bound.append(httpd)
        return httpd

    monkeypatch.setattr(port_serving, "serve_http", interrupted)
    assert port_cli.main([*argv[:-1]], config_override=port_config(servers.jcfg)) == 0
    assert bound[-1].socket.fileno() == -1
