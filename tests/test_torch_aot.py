"""The serving bundle on ``torch.export`` (``colxlip_tpu_torch/serving/aot.py``,
``scripts/torch_export_aot.py``) against the live port model and the JAX
bundle (``colxlip_tpu/serving/aot.py``) on the same weights (a JAX init of
``ViT-S-16-test-colxlip`` through ``convert``), all in fp32 on the CPU:

- a bundle with a symbolic batch loads without the model code's config and
  encodes batches of 1, 3 and 8: within 1e-5 of the live model and 1e-4 of
  the JAX bundle; its meta has the JAX keys;
- its attention is SDPA, one call a block of each tower (``resolve_impl``
  gives 'xla' while ``torch.export`` traces, as the JAX dispatch leaves
  the Pallas kernel under symbolic dims);
- the script's bundle from a ``.pt`` with ``--static-batch`` and
  ``--uint8-images``: uint8 images normalised by the tower, the pinned
  batch refused otherwise;
- the errors: another device type (the advice to re-export), a wrong
  format, wrong token and image shapes, a model built on the fused
  LayerNorm / MLP kernels.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.serving import aot as jax_aot
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.ops import attention
from colxlip_tpu_torch.serving import aot
from colxlip_tpu_torch.training.checkpoint import save_pt_checkpoint

MODEL = "ViT-S-16-test-colxlip"
LIVE_TOL = 1e-5
JAX_TOL = 1e-4
BATCHES = (1, 3, 8)


def _tokens(n, ctx, seed):
    rng = np.random.default_rng(seed)
    t = np.zeros((n, ctx), np.int64)
    t[:, 0] = 49406
    for i, end in enumerate(rng.integers(3, ctx - 1, n)):
        t[i, 1:end] = rng.integers(1, 49000, end - 1)
        t[i, end] = 49407
    return t


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(port model, cfg, the port bundle's path and meta, the JAX bundle)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("COLXLIP_GELU_IMPL", "stock")
    jmodel, jcfg = jax_create_model(MODEL, precision="fp32")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)),
                                  jnp.zeros((1, 32), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    work = tmp_path_factory.mktemp("aot")
    jax_dir = str(work / "jax")
    jax_aot.save_aot_bundle(jax_dir, jmodel, params, jcfg, model_name=MODEL, platforms=("cpu",))
    jax_bundle = jax_aot.load_aot_bundle(jax_dir)
    model, cfg = factory.create_model(MODEL, "cpu", torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.state_dict_from_jax_params(params).items()}, strict=True)
    port_dir = str(work / "port")
    meta = aot.save_aot_bundle(port_dir, model, cfg, model_name=MODEL)
    yield {"model": model, "cfg": cfg, "dir": port_dir, "meta": meta, "jax": jax_bundle,
           "jax_dir": jax_dir, "loaded": aot.load_aot_bundle(port_dir, device="cpu")}
    mp.undo()


@pytest.mark.parametrize("batch", BATCHES)
def test_symbolic_batch_matches_live_model_and_jax_bundle(bundles, batch):
    bundle = bundles["loaded"]
    model = bundles["model"]
    tokens, images = _tokens(batch, 32, batch), _images(batch, batch)
    got = bundle.encode_text(tokens) + bundle.encode_image(images)
    with torch.no_grad():
        live = (model.encode_text(torch.from_numpy(tokens), normalize=True)
                + model.encode_image(torch.from_numpy(images), normalize=True))
    ref = (bundles["jax"].encode_text(tokens.astype(np.int32))
           + bundles["jax"].encode_image(images))
    assert len(got) == len(live) == len(ref) == 4
    for g, w, r in zip(got, live, ref):
        assert g.shape == w.shape == r.shape and g.shape[0] == batch
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=LIVE_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=JAX_TOL)


def test_meta_has_the_jax_keys(bundles):
    meta = bundles["meta"]
    with open(os.path.join(bundles["jax_dir"], "meta.json")) as f:
        want = json.load(f)
    assert set(meta) == set(want)
    for key in ("format", "model", "embed_dim", "context_length", "image_size", "image_dtype",
                "static_batch", "outputs"):
        assert meta[key] == want[key], key
    assert meta["logit_scale"] == pytest.approx(want["logit_scale"], rel=1e-6)
    assert meta["platforms"] == ["cpu"]
    assert set(meta["bytes"]) == {"encode_text", "encode_image"}
    assert all(os.path.getsize(os.path.join(bundles["dir"], f"{k}.pt2")) == v
               for k, v in meta["bytes"].items())


def test_bundle_attention_is_sdpa(bundles, monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert attention.resolve_impl("fused") == "xla" and attention.resolve_impl("flash") == "flash"
    monkeypatch.setenv("COLXLIP_ATTN_IMPL", "fused")
    assert attention.resolve_impl("auto") == "xla"
    cfg, loaded = bundles["cfg"], bundles["loaded"]
    for name, module, layers in (("encode_image", loaded._image, cfg.vision_cfg.layers),
                                 ("encode_text", loaded._text, cfg.text_cfg.layers)):
        calls = [n for n in module.graph.nodes if n.op == "call_function"
                 and "scaled_dot_product" in str(n.target)]
        assert len(calls) == layers, name


def test_script_bundle_pins_the_batch_and_takes_uint8(bundles, tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_export_aot", os.path.join(os.path.dirname(__file__), "..", "scripts",
                                         "torch_export_aot.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    pt = str(tmp_path / "model.pt")
    save_pt_checkpoint(pt, bundles["model"])
    out = str(tmp_path / "bundle")
    assert script.main(["--model", MODEL, "--checkpoint", pt, "--out", out, "--static-batch",
                        "3", "--uint8-images", "--precision", "fp32", "--device", "cpu"]) == 0
    bundle = aot.load_aot_bundle(out, device="cpu")
    assert bundle.meta["static_batch"] == 3 and bundle.meta["image_dtype"] == "uint8"
    raw = np.random.default_rng(5).integers(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    got = bundle.encode_image(raw)
    with torch.no_grad():
        live = bundles["model"].encode_image(torch.from_numpy(raw), normalize=True)
    for g, w in zip(got, live):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=LIVE_TOL)
    with pytest.raises(ValueError, match="static_batch=3, got a batch of 4"):
        bundle.encode_image(np.zeros((4, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="static_batch=3, got a batch of 2"):
        bundle.encode_text(_tokens(2, 32, 0))


def test_errors(bundles, tmp_path):
    with pytest.raises(ValueError, match=r"exported for \['cpu'\] but the requested device is "
                                         r"'cuda' — re-export on it"):
        aot.load_aot_bundle(bundles["dir"], device="cuda")
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "meta.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a colxlip AOT bundle"):
        aot.load_aot_bundle(str(bad), device="cpu")
    bundle = bundles["loaded"]
    with pytest.raises(ValueError, match=r"tokens must be \[b, 32\] int64, got \(2, 31\)"):
        bundle.encode_text(np.zeros((2, 31), np.int64))
    with pytest.raises(ValueError, match=r"images must be \[b, 64, 64, 3\] float32, "
                                         r"got \(2, 64, 64\)"):
        bundle.encode_image(np.zeros((2, 64, 64), np.float32))
    with pytest.raises(ValueError, match="static_batch must be >= 1"):
        aot.export_towers(bundles["model"], bundles["cfg"], static_batch=0)


def test_fused_towers_are_refused(monkeypatch):
    monkeypatch.setenv("COLXLIP_LN_IMPL", "fused")
    model, cfg = factory.create_model(MODEL, "cpu", torch.float32)
    with pytest.raises(ValueError, match="torch.export cannot trace"):
        aot.export_towers(model, cfg)
