"""colxlip_tpu_torch models, weights, tokenizer and transform against the JAX
package, on the same seeded numpy inputs and the same weights (JAX init ->
``state_dict_from_jax_params`` -> ``load_state_dict(strict=True)``).

Tolerances: tower features 2e-4 in fp32 (the bar of tests/test_pt_export.py;
the JAX GELU is a degree-9 tanh-structured erf, 3.4e-6 from the port's exact
erf), scores 2e-4 * logit_scale.
"""
from __future__ import annotations

import dataclasses
import io
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from colxlip_tpu.data.tokenizer import get_tokenizer_cached as jax_tokenizer
from colxlip_tpu.data.transforms import image_transform as jax_image_transform
from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.models import configs as jax_configs
from colxlip_tpu.training.checkpoint import export_pt_state_dict
from colxlip_tpu.training.evaluate import score_similarity as jax_score_similarity
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.data.tokenizer import get_tokenizer_cached
from colxlip_tpu_torch.data.transforms import image_transform
from colxlip_tpu_torch.models import ColXLIP, configs
from colxlip_tpu_torch.training.evaluate import score_similarity

TINY = "ViT-S-16-test-colxlip"
FEATURE_ATOL = 2e-4


@pytest.fixture(scope="module")
def jax_model():
    model, cfg = jax_create_model(TINY, precision="fp32")
    imgs = jnp.zeros((1, 64, 64, 3), jnp.float32)
    txts = jnp.zeros((1, 32), jnp.int32).at[:, 0].set(49406).at[:, 1].set(49407)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), imgs, txts)
    return model, params


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, params = jax_model
    model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def _inputs(seed=0, b=3, ctx=32):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, 64, 64, 3)).astype(np.float32)
    txts = np.zeros((b, ctx), np.int32)
    txts[:, 0] = 49406
    txts[:, 1:8] = rng.integers(1, 49000, (b, 7))
    for i in range(b):
        txts[i, 8 + i] = 49407
    return imgs, txts


def _encode_both(jax_model, port_model, imgs, txts):
    model, params = jax_model
    j_img = jax.jit(lambda p, x: model.apply(
        p, x, method=lambda m, x: m.encode_image(x, normalize=True)))(
            params, jnp.asarray(imgs))
    j_txt = jax.jit(lambda p, x: model.apply(
        p, x, method=lambda m, x: m.encode_text(x, normalize=True)))(
            params, jnp.asarray(txts))
    with torch.no_grad():
        p_img = port_model.encode_image(torch.from_numpy(imgs), normalize=True)
        p_txt = port_model.encode_text(torch.from_numpy(txts), normalize=True)
    return (j_img, j_txt), (p_img, p_txt)


def test_config_registry_matches_jax():
    assert configs.list_models() == jax_configs.list_models()
    for name in configs.list_models():
        want = jax_configs.CLIPCfg.from_dict(jax_configs.get_model_config(name))
        got = configs.CLIPCfg.from_dict(configs.get_model_config(name))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    cfg = configs.CLIPCfg.from_dict(configs.get_model_config("ViT-B-16-colxlip"))
    assert (cfg.vision_cfg.width, cfg.vision_cfg.heads, cfg.vision_cfg.num_patches,
            cfg.text_cfg.width, cfg.text_cfg.heads, cfg.embed_dim) == (
                768, 12, 196, 512, 8, 512)


def test_tokenizer_ids_match_jax():
    captions = [
        "a photo of a cat",
        "Two DOGS playing   on the grass!!",
        "",
        "café crème brûlée — “quoted” ﬁne",
        "東京タワー at night \U0001F303",
        "mojibake: lâ€™humanitÃ© &amp; co",
        "numbers 12345 and punctuation: a.b,c;d",
        " ".join(f"word{i}" for i in range(60)),  # truncated, EOT forced last
    ]
    want = jax_tokenizer(77)(captions)
    got = get_tokenizer_cached(77)(captions)
    assert got.dtype == np.int32 and got.shape == (len(captions), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == 49407 and (got[:, 0] == 49406).all()
    np.testing.assert_array_equal(get_tokenizer_cached(32)(captions[:3]),
                                  jax_tokenizer(32)(captions[:3]))


def test_eval_transform_matches_jax():
    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (90, 130, 3), np.uint8)).save(
        buf, format="JPEG")
    img = Image.open(io.BytesIO(buf.getvalue()))
    for size in (64, 224):
        want = jax_image_transform(size, is_train=False)(img)
        got = image_transform(size, is_train=False)(img)
        assert got.shape == (size, size, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_state_dict_matches_export(jax_model):
    _, params = jax_model
    params_np = jax.tree.map(np.asarray, params)
    got = convert.state_dict_from_jax_params(params_np)
    want = export_pt_state_dict(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_strict_load_covers_every_parameter(jax_model):
    _, params = jax_model
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    with pytest.raises(ValueError, match="no .pt mapping"):
        bad = jax.tree.map(np.asarray, params)
        bad["params"]["visual"]["mystery"] = np.zeros(3)
        convert.state_dict_from_jax_params(bad)


def test_pt_checkpoint_roundtrip(port_model, tmp_path):
    path = str(tmp_path / "w.pt")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               port_model.state_dict().items()}}, path)
    model, _ = factory.create_model(TINY, "cpu", torch.float32, seed=1)
    factory.load_weights(model, path)
    for k, v in port_model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_tower_features_match_jax(jax_model, port_model, tower):
    imgs, txts = _inputs()
    (j_img, j_txt), (p_img, p_txt) = _encode_both(jax_model, port_model, imgs, txts)
    want, got = (j_img, p_img) if tower == "image" else (j_txt, p_txt)
    for w, g in zip(want, got):  # pooled, then token features
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)


def test_text_tokens_zeroed_at_and_after_eot_before_head(port_model):
    _, txts = _inputs(seed=1)
    with torch.no_grad():
        _, tok = port_model.encode_text(torch.from_numpy(txts), normalize=False)
    # every row's positions >= EOT carry the same vector (the head's
    # response to a zero input)
    for i in range(txts.shape[0]):
        eot = int(txts[i].argmax())
        torch.testing.assert_close(tok[i, eot:], tok[i, eot:eot + 1].expand_as(tok[i, eot:]))


@pytest.mark.parametrize("scoring,mask_mode", [
    ("global", "nonzero"), ("maxsim", "nonzero"), ("mixed", "nonzero"),
    ("maxsim", "plain"), ("mixed", "valid"),
])
def test_score_similarity_matches_jax(jax_model, port_model, scoring, mask_mode):
    imgs, txts = _inputs(seed=2, b=4)
    (j_img, j_txt), (p_img, p_txt) = _encode_both(jax_model, port_model, imgs, txts)
    scale = float(np.exp(np.asarray(jax_model[1]["params"]["logit_scale"])))
    text_mask = (np.arange(txts.shape[1])[None, :]
                 < txts.argmax(axis=-1)[:, None]).astype(np.float32)
    want = jax_score_similarity(
        np.asarray(j_img[0]), np.asarray(j_txt[0]), np.asarray(j_img[1]),
        np.asarray(j_txt[1]), scale, scoring=scoring, alpha=0.3,
        mask_mode=mask_mode, text_mask=text_mask)
    got = score_similarity(p_img[0], p_txt[0], p_img[1], p_txt[1], scale,
                           scoring=scoring, alpha=0.3, mask_mode=mask_mode,
                           text_mask=torch.from_numpy(text_mask))
    assert tuple(got.shape) == (4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * scale)


def test_load_weights_plain_clip_checkpoint_keeps_token_heads(port_model, tmp_path):
    """A plain-CLIP .pt loads into ColXLIP with the token heads left at init;
    any other missing or unexpected key is refused."""
    sd = {k: v for k, v in port_model.state_dict().items()
          if not k.startswith(("vision_token_layer.", "text_token_layer."))}
    torch.save(sd, tmp_path / "clip.pt")
    model, _ = factory.create_model(TINY, "cpu", torch.float32, seed=1)
    head = model.state_dict()["text_token_layer.1.weight"].clone()
    factory.load_weights(model, str(tmp_path / "clip.pt"))
    torch.testing.assert_close(model.state_dict()["visual.proj"], sd["visual.proj"])
    torch.testing.assert_close(model.state_dict()["text_token_layer.1.weight"], head)
    for bad in ({**sd, "mystery": torch.zeros(1)},
                {k: v for k, v in sd.items() if k != "ln_final.bias"}):
        torch.save(bad, tmp_path / "bad.pt")
        with pytest.raises(RuntimeError, match="keys"):
            factory.load_weights(model, str(tmp_path / "bad.pt"))


def test_create_model_is_seeded():
    a, cfg = factory.create_model(TINY, "cpu", torch.float32, seed=5)
    b, _ = factory.create_model(TINY, "cpu", torch.float32, seed=5)
    c, _ = factory.create_model(TINY, "cpu", torch.float32, seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["visual.proj"], sc["visual.proj"])
    assert float(sa["logit_scale"]) == pytest.approx(cfg.init_logit_scale)
    assert all(v.dtype == torch.float32 for v in sa.values())


def test_port_never_imports_jax():
    code = ("import sys; import colxlip_tpu_torch.serving.server; "
            "import colxlip_tpu_torch.convert; "
            "import colxlip_tpu_torch.parallel.train_step; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'colxlip_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
