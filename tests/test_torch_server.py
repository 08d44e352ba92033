"""colxlip_tpu_torch serving: the real ThreadingHTTPServer on an ephemeral
port, the tiny colxlip config in fp32 on the CPU, weights from a JAX init, so
that /v1/score can be held against the JAX package's ``score_similarity`` of
the JAX model on the same weights (within 2e-4 * logit_scale), and
/v1/search against the JAX ``RetrievalIndex.search`` on the JAX model's text
features over the same index.

Also: ``chip_smoke.py`` refuses to run (non-zero exit, no result) without a
GPU, or in a directory without the package.
"""
from __future__ import annotations

import base64
import io
import json
import os
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.serving.index import RetrievalIndex as JaxRetrievalIndex
from colxlip_tpu.training.evaluate import score_similarity as jax_score_similarity
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.models import ColXLIP
from colxlip_tpu_torch.serving import server as server_mod
from colxlip_tpu_torch.serving.index import build_image_index
from colxlip_tpu_torch.serving.server import (
    ColXLIPService, DynamicBatcher, InferenceEngine, make_server, next_bucket,
)

TINY = "ViT-S-16-test-colxlip"
REPO = pathlib.Path(__file__).resolve().parents[1]


def _post(port: int, path: str, obj: dict, expect: int = 200) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == expect
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect, f"{e.code}: {e.read()!r}"
        return json.loads(e.read())


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _jpeg_b64(rng: np.random.Generator, size: int = 80) -> str:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)).save(
        buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def jax_model():
    model, _ = jax_create_model(TINY, precision="fp32")
    imgs = jnp.zeros((1, 64, 64, 3), jnp.float32)
    txts = jnp.zeros((1, 32), jnp.int32).at[:, 0].set(49406).at[:, 1].set(49407)
    params = jax.jit(model.init)(jax.random.PRNGKey(7), imgs, txts)
    encode = {
        "text": jax.jit(lambda p, x: model.apply(
            p, x, method=lambda m, x: m.encode_text(x, normalize=True))),
        "image": jax.jit(lambda p, x: model.apply(
            p, x, method=lambda m, x: m.encode_image(x, normalize=True))),
    }
    return params, encode


def _port_model(params) -> ColXLIP:
    model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def server(jax_model):
    params, _ = jax_model
    model = _port_model(params)
    svc = ColXLIPService(TINY, device="cpu", dtype=torch.float32, max_batch=8,
                         max_wait_ms=2.0, model=model, cfg=model.cfg)
    httpd = make_server(svc, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield svc, httpd.server_address[1]
    httpd.shutdown()
    svc.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def test_next_bucket():
    assert [next_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9, 100)] == \
        [1, 2, 4, 8, 8, 8, 8]


def test_healthz_and_metrics(server):
    _, port = server
    body = _get(port, "/healthz")
    assert (body["status"], body["embed_dim"], body["context_length"],
            body["device"]) == ("ok", 128, 32, "cpu")
    _post(port, "/v1/embed/text", {"texts": ["warm the counters"]})
    m = _get(port, "/metrics")
    assert m["requests"]["/v1/embed/text"] >= 1
    assert m["batcher"]["text"]["items"] >= m["batcher"]["text"]["waves"] >= 1


def test_batcher_counts_a_wave_before_its_results_resolve():
    """A done-callback runs in the batcher thread inside ``set_result``: the
    wave it belongs to must already be in ``stats``, or a client that reads
    /metrics after its response can miss it."""
    batcher = DynamicBatcher(lambda x: (x * 2,), max_batch=4, max_wait_ms=0.0)
    seen = []
    try:
        fut = batcher.submit(np.ones((2, 3), np.float32))
        fut.add_done_callback(lambda f: seen.append(
            (batcher.stats["waves"], batcher.stats["items"])))
        np.testing.assert_array_equal(fut.result(timeout=30)[0], 2.0)
    finally:
        batcher.stop()
    assert seen == [(1, 2)]


def test_post_is_recorded_before_its_response_is_written():
    """``do_POST`` records the request before the body goes out (and still
    records a request whose handler raised before sending anything)."""
    class Service:
        def __init__(self):
            self.recorded = []

        def record(self, path, seconds):
            self.recorded.append(path)

    class Wire:
        def __init__(self, svc):
            self.svc, self.seen = svc, []

        def write(self, body):
            self.seen.append(list(self.svc.recorded))

    svc = Service()
    handler = server_mod._Handler.__new__(type("H", (server_mod._Handler,), {"service": svc}))
    handler.path, handler.wfile = "/v1/embed/text", Wire(svc)
    handler.send_response = handler.send_header = lambda *a: None
    handler.end_headers = lambda: None
    handler._route_post = lambda: handler._send(200, {"ok": True})
    handler.do_POST()
    assert handler.wfile.seen == [["/v1/embed/text"]]
    assert svc.recorded == ["/v1/embed/text"]

    def fail():
        raise ConnectionResetError("client went away")
    handler._route_post = fail
    with pytest.raises(ConnectionResetError):
        handler.do_POST()
    assert svc.recorded == ["/v1/embed/text"] * 2


def test_embed_text_normalized_and_bucket_invariant(server):
    _, port = server
    texts = ["a photo of a cat", "two dogs on grass", "blue car"]
    emb = np.asarray(_post(port, "/v1/embed/text", {"texts": texts})["embeddings"],
                     np.float32)
    assert emb.shape == (3, 128)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
    # one item (bucket 1) == row 0 of three (bucket 4, one pad row)
    solo = np.asarray(_post(port, "/v1/embed/text",
                            {"texts": texts[:1]})["embeddings"], np.float32)
    np.testing.assert_allclose(solo[0], emb[0], atol=2e-5)


def test_embed_image_bucket_invariant_with_tokens(server):
    _, port = server
    rng = np.random.default_rng(0)
    imgs = [_jpeg_b64(rng) for _ in range(3)]
    resp = _post(port, "/v1/embed/image", {"images_b64": imgs, "return_tokens": True})
    emb = np.asarray(resp["embeddings"], np.float32)
    toks = np.asarray(resp["token_embeddings"], np.float32)
    assert emb.shape == (3, 128) and toks.shape == (3, 16, 128)
    np.testing.assert_allclose(np.linalg.norm(toks, axis=-1), 1.0, atol=1e-5)
    solo = _post(port, "/v1/embed/image", {"images_b64": imgs[:1]})
    np.testing.assert_allclose(np.asarray(solo["embeddings"], np.float32)[0],
                               emb[0], atol=2e-5)


def test_oversize_request_splits_into_waves(server):
    _, port = server
    texts = [f"text {i}" for i in range(19)]  # > max_batch=8
    resp = _post(port, "/v1/embed/text", {"texts": texts})
    assert np.asarray(resp["embeddings"]).shape == (19, 128)


@pytest.mark.parametrize("scoring", ["global", "maxsim", "mixed"])
def test_score_matches_jax_model(server, jax_model, scoring):
    svc, port = server
    params, encode = jax_model
    rng = np.random.default_rng(1)
    texts = ["a red square", "the night sky", "ok"]
    imgs = [_jpeg_b64(rng) for _ in range(2)]
    sim = np.asarray(_post(port, "/v1/score", {
        "texts": texts, "images_b64": imgs, "scoring": scoring,
        "alpha": 0.25})["similarity"], np.float32)
    assert sim.shape == (2, 3)
    j_txt = encode["text"](params, jnp.asarray(svc.tokenize(texts)))
    j_img = encode["image"](params, jnp.asarray(svc.decode_images(imgs)))
    scale = float(np.exp(np.asarray(params["params"]["logit_scale"])))
    want = jax_score_similarity(
        np.asarray(j_img[0]), np.asarray(j_txt[0]), np.asarray(j_img[1]),
        np.asarray(j_txt[1]), scale, scoring=scoring, alpha=0.25)
    np.testing.assert_allclose(sim, want, atol=2e-4 * scale)


@pytest.mark.parametrize("path,body", [
    pytest.param("/v1/caption", {"images_b64": ["aGk="]}, id="/v1/caption-body1"),
])
def test_unported_endpoints_answer_400(server, path, body):
    """/v1/caption on a model without a caption decoder answers 400 with the
    JAX server's message (it was 400 "not yet ported" before CoCa was)."""
    _, port = server
    resp = _post(port, path, body, expect=400)
    assert resp["error"] == (f"{TINY!r} has no caption decoder — captioning needs a CoCa "
                             "model")


@pytest.fixture(scope="module")
def coca_server():
    model, cfg = factory.create_model("coca-S-test", "cpu", torch.float32, seed=4)
    svc = ColXLIPService("coca-S-test", device="cpu", dtype=torch.float32, max_batch=2,
                         model=model, cfg=cfg)
    httpd = make_server(svc, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield svc, httpd.server_address[1]
    httpd.shutdown()
    svc.stop()
    t.join(timeout=10)


def test_caption_answers_the_greedy_strings(coca_server):
    """/v1/caption on coca-S-test: 200 and, for 3 images (two decodes at
    max_batch 2), the strings of generate_captions' greedy tokens; a
    sampled request repeats under its seed."""
    from colxlip_tpu_torch.serving.generate import generate_captions, tokens_to_text

    svc, port = coca_server
    rng = np.random.default_rng(5)
    imgs = [_jpeg_b64(rng) for _ in range(3)]
    resp = _post(port, "/v1/caption", {"images_b64": imgs, "max_len": 12})
    want = tokens_to_text(generate_captions(svc.model, svc.decode_images(imgs), max_len=12),
                          svc.tokenizer)
    assert resp == {"captions": want} and len(want) == 3
    body = {"images_b64": imgs[:2], "method": "top_k", "top_k": 5, "seed": 3, "max_len": 8}
    assert _post(port, "/v1/caption", body) == _post(port, "/v1/caption", body)
    bad = _post(port, "/v1/caption", {"images_b64": imgs[:1], "method": "beam"}, expect=400)
    assert "unknown decode method" in bad["error"]


def test_search_without_an_index_answers_400(server):
    svc, port = server
    resp = _post(port, "/v1/search", {"texts": ["x"], "k": 3}, expect=400)
    assert "--index" in resp["error"] and svc.index is None
    assert _get(port, "/healthz")["index_items"] is None
    assert _get(port, "/metrics")["index_items"] is None


N_CORPUS = 24
SEARCH_TEXTS = ["a red square", "the night sky over the sea", "ok"]


@pytest.fixture(scope="module")
def index_dir(jax_model, tmp_path_factory):
    """24 seeded images through the port's model, with string ids."""
    rng = np.random.default_rng(5)
    images = rng.standard_normal((N_CORPUS, 64, 64, 3)).astype(np.float32)
    return build_image_index(
        _port_model(jax_model[0]), iter(images), str(tmp_path_factory.mktemp("index")),
        device="cpu", ids=[f"img{i:02d}" for i in range(N_CORPUS)], batch_size=8,
        model_name=TINY)


@pytest.fixture(scope="module", params=["nonzero", "valid"])
def search_server(request, jax_model, index_dir):
    svc = ColXLIPService(TINY, device="cpu", dtype=torch.float32, max_batch=8,
                         max_wait_ms=2.0, model=_port_model(jax_model[0]),
                         cfg=factory.model_config(TINY), index_dir=index_dir,
                         mask_mode=request.param)
    httpd = make_server(svc, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield svc, httpd.server_address[1]
    httpd.shutdown()
    svc.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _jax_search(svc, jax_model, index_dir, texts, **kwargs):
    """The JAX index's search on the JAX model's features of the same texts,
    with the 'valid' mask the JAX service builds."""
    params, encode = jax_model
    tokens = svc.tokenize(texts)
    pooled, q_tokens = (np.asarray(x) for x in encode["text"](params, jnp.asarray(tokens)))
    mask = None
    if svc.mask_mode == "valid":
        mask = (np.arange(tokens.shape[1])[None, :]
                < tokens.argmax(axis=-1)[:, None]).astype(np.float32)
    return JaxRetrievalIndex(index_dir).search(pooled, q_tokens, mask_mode=svc.mask_mode,
                                               text_mask=mask, **kwargs)


@pytest.mark.parametrize("scoring", ["global", "maxsim", "mixed"])
@pytest.mark.parametrize("shortlist", [6, N_CORPUS])
def test_search_matches_the_jax_index(search_server, jax_model, index_dir, scoring, shortlist):
    """/v1/search over HTTP against the JAX search: the same scores within
    2e-4 * logit_scale (the bar of /v1/score), and the same items wherever
    the JAX scores are further apart than that."""
    svc, port = search_server
    resp = _post(port, "/v1/search", {"texts": SEARCH_TEXTS, "k": 4, "shortlist": shortlist,
                                      "scoring": scoring, "alpha": 0.25})
    idx, scores = np.asarray(resp["indices"]), np.asarray(resp["scores"], np.float32)
    want_idx, want_scores, want_ids = _jax_search(
        svc, jax_model, index_dir, SEARCH_TEXTS, k=4, shortlist=shortlist, scoring=scoring,
        alpha=0.25)
    tol = 2e-4 * svc.logit_scale
    assert idx.shape == scores.shape == (3, 4)
    np.testing.assert_allclose(scores, want_scores, atol=tol)
    clear = np.abs(np.diff(want_scores, axis=1)).min(axis=1) > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(idx[clear], want_idx[clear])
    assert resp["ids"] == [[f"img{i:02d}" for i in row] for row in idx]
    assert (np.diff(scores, axis=1) <= 0).all()


def test_search_defaults_and_index_items(search_server, jax_model, index_dir):
    svc, port = search_server
    assert _get(port, "/healthz")["index_items"] == N_CORPUS
    resp = _post(port, "/v1/search", {"texts": SEARCH_TEXTS[:1]})
    # defaults: k 10, shortlist 100 (cut to the corpus), maxsim for a token model
    want = _jax_search(svc, jax_model, index_dir, SEARCH_TEXTS[:1], k=10, shortlist=100,
                       scoring="maxsim")
    assert np.asarray(resp["indices"]).shape == (1, 10)
    np.testing.assert_allclose(np.asarray(resp["scores"], np.float32), want[1],
                               atol=2e-4 * svc.logit_scale)
    m = _get(port, "/metrics")
    assert m["index_items"] == N_CORPUS and m["requests"]["/v1/search"] >= 1
    assert "error" in _post(port, "/v1/search", {"texts": ["a"], "scoring": "best"}, expect=400)
    assert "error" in _post(port, "/v1/search", {"k": 3}, expect=400)


def test_valid_mask_changes_the_search_scores(jax_model, index_dir):
    """The 'valid' text mask reaches the rerank: positions from the EOT on are
    left out of the mean, which the 'nonzero' rule keeps when they are not 0."""
    model = _port_model(jax_model[0])
    scores = {}
    for mode in ("nonzero", "valid", "plain"):
        svc = ColXLIPService(TINY, device="cpu", dtype=torch.float32, max_batch=8, model=model,
                             cfg=model.cfg, index_dir=index_dir, mask_mode=mode)
        try:
            scores[mode] = svc.search(SEARCH_TEXTS, k=N_CORPUS, shortlist=N_CORPUS)[1]
        finally:
            svc.stop()
    assert not np.allclose(scores["valid"], scores["plain"])
    assert all(np.isfinite(s).all() for s in scores.values())


def test_server_main_passes_the_index_on(monkeypatch, index_dir):
    """``--index <dir>`` reaches the service; main serves until interrupted."""
    seen = {}

    class FakeService:
        def __init__(self, *args, **kwargs):
            seen.update(kwargs)

        def stop(self):
            seen["stopped"] = True

    class FakeServer:
        server_address = ("127.0.0.1", 1)

        def serve_forever(self):
            raise KeyboardInterrupt

    monkeypatch.setattr(server_mod, "ColXLIPService", FakeService)
    monkeypatch.setattr(server_mod, "make_server", lambda *a, **k: FakeServer())
    with pytest.raises(KeyboardInterrupt):
        server_mod.main(["--model", TINY, "--device", "cpu", "--index", index_dir])
    assert seen["index_dir"] == index_dir and seen["stopped"]


def test_errors(server):
    _, port = server
    assert "error" in _post(port, "/v1/embed/text", {"texts": []}, expect=400)
    assert "error" in _post(port, "/v1/embed/text", {"nope": 1}, expect=400)
    assert "error" in _post(port, "/v1/score", {"texts": ["a"], "images_b64": [
        _jpeg_b64(np.random.default_rng(2))], "scoring": "best"}, expect=400)
    assert "error" in _post(port, "/v1/nope", {"x": 1}, expect=404)


def test_text_buckets_equal_full_context(jax_model):
    params, _ = jax_model
    model = _port_model(params)
    full = model.cfg.text_cfg.context_length
    eng_b = InferenceEngine(model, "cpu", max_batch=8, text_ctx_buckets=(16,))
    eng_f = InferenceEngine(model, "cpu", max_batch=8)

    rng = np.random.default_rng(0)
    short = np.zeros((3, full), np.int32)
    short[:, 0] = 49406
    short[:, 1:6] = rng.integers(1, 49000, (3, 5))
    short[:, 6] = 49407
    out_b = eng_b.run("text", short)
    assert eng_b.last_text_ctx == 16
    out_f = eng_f.run("text", short)
    assert len(out_b) == len(out_f) == 2
    for ob, of in zip(out_b, out_f):
        assert ob.shape == of.shape  # token features padded back to full
        np.testing.assert_allclose(ob.numpy(), of.numpy(), atol=2e-5)

    long = short.copy()  # a caption past the bucket routes to the full context
    long[:, 6] = 1
    long[:, full - 1] = 49407
    eng_b.run("text", long)
    assert eng_b.last_text_ctx == full
    no_eot = short.copy()  # without EOT in every row, never cut
    no_eot[0, 6] = 1
    eng_b.run("text", no_eot)
    assert eng_b.last_text_ctx == full
    eng_b.warmup({"text": (full,), "image": (64, 64, 3)})


def test_batcher_failure_isolated():
    def fn(batch):
        if batch[0, 0] < 0:
            raise RuntimeError("boom")
        return (batch * 2,)

    b = DynamicBatcher(fn, max_batch=4, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError):
            b.submit(np.full((1, 2), -1.0)).result(timeout=10)
        (out,) = b.submit(np.ones((2, 2))).result(timeout=10)
        np.testing.assert_allclose(out, 2.0)
        assert b.stats["failures"] == 1
    finally:
        b.stop()


def test_random_init_service_on_cpu_device():
    svc = ColXLIPService(TINY, device="cpu", dtype=torch.float32, max_batch=4,
                         seed=3)
    try:
        pooled, tokens = svc.embed("text", svc.tokenize(["hello", "world"]))
        assert pooled.device.type == "cpu" and tokens.shape == (2, 32, 128)
        assert svc.logit_scale == pytest.approx(np.exp(svc.cfg.init_logit_scale))
    finally:
        svc.stop()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu_or_package(where, tmp_path):
    """No result and a non-zero exit without a GPU, and in a directory that
    holds chip_smoke.py and nothing else of the repository."""
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
