"""colxlip_tpu_torch serving: the real ThreadingHTTPServer on an ephemeral
port, the tiny colxlip config in fp32 on the CPU, weights from a JAX init, so
that /v1/score can be held against the JAX package's ``score_similarity`` of
the JAX model on the same weights (within 2e-4 * logit_scale).

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
from colxlip_tpu.training.evaluate import score_similarity as jax_score_similarity
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.models import ColXLIP
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
    ("/v1/search", {"texts": ["x"], "k": 3}),
    ("/v1/caption", {"images_b64": ["aGk="]}),
])
def test_unported_endpoints_answer_400(server, path, body):
    _, port = server
    resp = _post(port, path, body, expect=400)
    assert "not yet ported in colxlip_tpu_torch" in resp["error"]


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
