"""colxlip_tpu_torch models, weights, tokenizer and transform against the JAX
package, on the same seeded numpy inputs and the same weights (JAX init ->
``state_dict_from_jax_params`` -> ``load_state_dict(strict=True)``).

Tolerances: tower features 2e-4 in fp32 (the bar of tests/test_pt_export.py;
the JAX GELU is a degree-9 tanh-structured erf, 3.4e-6 from the port's exact
erf, and the fused MLP's erf polynomial is 1.5e-7 from it), scores 2e-4 *
logit_scale. The tower options (LayerScale, sin-cos positions, ``no_ln_pre``,
``final_ln_after_pool``, the pool types, the uint8 feed, the text tower's
``no_causal_mask``) are held to the JAX towers at the same bar on converted
weights.
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
from colxlip_tpu.models import pos_embed as jax_pos_embed
from colxlip_tpu.models.clip import ColXLIP as JaxColXLIP
from colxlip_tpu.training.checkpoint import export_pt_state_dict, load_pt_checkpoint
from colxlip_tpu.training.evaluate import score_similarity as jax_score_similarity
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.data.tokenizer import get_tokenizer_cached
from colxlip_tpu_torch.data.transforms import image_transform
from colxlip_tpu_torch.models import ColXLIP, configs
from colxlip_tpu_torch.models import layers as port_layers
from colxlip_tpu_torch.training.checkpoint import save_pt_checkpoint
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


def _load_converted(model, params):
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("tower", ["image", "text"])
def test_tower_features_match_jax_through_fused_kernels(jax_model, monkeypatch, tower):
    """Both towers with COLXLIP_LN_IMPL=fused COLXLIP_MLP_IMPL=fused (on the
    CPU: the kernels' plain versions) against the JAX model's features."""
    monkeypatch.setenv("COLXLIP_LN_IMPL", "fused")
    monkeypatch.setenv("COLXLIP_MLP_IMPL", "fused")
    model = _load_converted(ColXLIP(factory.model_config(TINY), dtype=torch.float32),
                            jax_model[1])
    assert all(m.fused for m in model.modules() if isinstance(m, port_layers.MLP))
    assert all(m.impl == "fused" for m in model.modules()
               if isinstance(m, port_layers.LayerNorm))
    # the JAX package reads the same two variables (and its kernels need a
    # TPU): unset them for its side; the port's modules read them when built
    monkeypatch.delenv("COLXLIP_LN_IMPL")
    monkeypatch.delenv("COLXLIP_MLP_IMPL")
    imgs, txts = _inputs(seed=5)
    (j_img, j_txt), (p_img, p_txt) = _encode_both(jax_model, model, imgs, txts)
    want, got = (j_img, p_img) if tower == "image" else (j_txt, p_txt)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)


def _option_pair(vision=None, text=None):
    """A JAX ColXLIP and the port's on the tiny config with ``vision_cfg`` /
    ``text_cfg`` fields overridden, on the same (JAX-initialised) weights."""
    jcfg = jax_configs.CLIPCfg.from_dict(jax_configs.get_model_config(TINY))
    pcfg = factory.model_config(TINY)
    for cfgs, overrides in (((jcfg.vision_cfg, pcfg.vision_cfg), vision or {}),
                            ((jcfg.text_cfg, pcfg.text_cfg), text or {})):
        for cfg in cfgs:
            for k, v in overrides.items():
                assert hasattr(cfg, k), k
                setattr(cfg, k, v)
    jmodel = JaxColXLIP(jcfg, dtype=jnp.float32)
    size = jcfg.vision_cfg.image_size
    imgs = jnp.zeros((1, size, size, 3), jnp.float32)
    txts = jnp.zeros((1, 32), jnp.int32).at[:, 0].set(49406).at[:, 1].set(49407)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(4), imgs, txts)
    return (jmodel, params), _load_converted(ColXLIP(pcfg, dtype=torch.float32), params)


VISION_OPTIONS = {
    "layer-scale": {"ls_init_value": 0.5},
    "sin-cos-positions": {"pos_embed_type": "sin_cos_2d"},
    "no-ln-pre": {"no_ln_pre": True},
    "final-ln-after-pool": {"final_ln_after_pool": True},
    "pool-avg": {"pool_type": "avg"},
    "pool-avg-ln-after": {"pool_type": "avg", "final_ln_after_pool": True},
    "pool-none": {"pool_type": "none"},
    "patch-dropout-in-eval": {"patch_dropout": 0.5},
    "attentional-pool": {"attentional_pool": True, "attn_pooler_queries": 6,
                         "attn_pooler_heads": 2},
}


def test_vit_l_14_shaped_vision_tower_matches_jax():
    """ViT-L/14's token count on a narrow tower: 224 px in patches of 14 is a
    16 x 16 grid, 257 tokens with the class token, one more than four key
    tiles of 64 (the sequence the first attention kernels refused). Two layers,
    width 128 in heads of 64; the same JAX-initialised weights on both sides,
    fp32, the bar of the other tower tests."""
    shape = {"image_size": 224, "patch_size": 14, "width": 128, "head_width": 64, "layers": 2}
    jax_pair, port = _option_pair(vision=shape)
    assert port.visual.positional_embedding.shape == (257, 128)
    rng = np.random.default_rng(8)
    imgs = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    _, txts = _inputs(seed=8, b=2)
    (j_img, _), (p_img, _) = _encode_both(jax_pair, port, imgs, txts)
    assert p_img[1].shape == (2, 256, 128)          # one token feature a patch
    for w, g in zip(j_img, p_img):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)


@pytest.mark.parametrize("option", list(VISION_OPTIONS))
def test_vision_tower_options_match_jax(option):
    jax_pair, port = _option_pair(vision=VISION_OPTIONS[option])
    imgs, txts = _inputs(seed=6)
    (j_img, _), (p_img, _) = _encode_both(jax_pair, port, imgs, txts)
    for w, g in zip(j_img, p_img):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)
    keys = set(port.state_dict())
    assert ("visual.ln_pre.weight" in keys) == (option != "no-ln-pre")
    assert ("visual.transformer.resblocks.0.ls_1.gamma" in keys) == (option == "layer-scale")


def test_uint8_images_are_normalised_on_the_device_as_jax_does(jax_model, port_model):
    model, params = jax_model
    raw = np.random.default_rng(7).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    want = jax.jit(lambda p, x: model.apply(
        p, x, method=lambda m, x: m.encode_image(x, normalize=True)))(params, jnp.asarray(raw))
    cfg = port_model.cfg.vision_cfg
    host = (raw.astype(np.float32) / np.float32(255.0)
            - np.asarray(cfg.image_mean, np.float32)) / np.asarray(cfg.image_std, np.float32)
    with torch.no_grad():
        got = port_model.encode_image(torch.from_numpy(raw), normalize=True)
        from_host = port_model.encode_image(torch.from_numpy(host), normalize=True)
    for w, g, h in zip(want, got, from_host):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)
        assert torch.equal(g, h)              # the host float32 transform, bit for bit
    with pytest.raises(ValueError, match="YUV420"):
        port_model.encode_image(torch.zeros(2, 96, 64))
    with pytest.raises(ValueError, match="NHWC"):
        port_model.encode_image(torch.zeros(2, 3, 64, 64))


def test_yuv420_images_match_the_jax_tower(jax_model, port_model):
    """A planar YUV420 batch [B, H*3//2, W] (uint8) decodes on the device and
    encodes to the JAX tower's features on the same weights."""
    from colxlip_tpu_torch.ops.yuv420 import rgb_to_yuv420

    model, params = jax_model
    rng = np.random.default_rng(8)
    coarse = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    yuv = rgb_to_yuv420(coarse.repeat(4, axis=1).repeat(4, axis=2))
    assert yuv.shape == (3, 96, 64)
    want = jax.jit(lambda p, x: model.apply(
        p, x, method=lambda m, x: m.encode_image(x, normalize=True)))(params, jnp.asarray(yuv))
    with torch.no_grad():
        got = port_model.encode_image(torch.from_numpy(yuv), normalize=True)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)


def test_sincos_tower_init_and_grid_check():
    model, cfg = factory.create_model(TINY, "cpu", torch.float32, seed=0)
    cfg.vision_cfg.pos_embed_type = "sin_cos_2d"
    model = ColXLIP(cfg, dtype=torch.float32)
    factory.init_weights(model, torch.Generator().manual_seed(0))
    want = jax_pos_embed.get_2d_sincos_pos_embed(cfg.vision_cfg.width, 4, cls_token=True)
    np.testing.assert_array_equal(model.visual.positional_embedding.detach().numpy(), want)
    cfg.vision_cfg.image_size = (64, 32)
    with pytest.raises(ValueError, match="square patch grid"):
        ColXLIP(cfg, dtype=torch.float32)
    cfg.vision_cfg.pos_embed_type = "rope"
    with pytest.raises(ValueError, match="pos_embed_type"):
        ColXLIP(cfg, dtype=torch.float32)


TEXT_OPTIONS = {
    "layer-scale": {"ls_init_value": 0.5},
    "no-causal-mask": {"no_causal_mask": True},
    "pool-first": {"pool_type": "first"},
    "pool-last": {"pool_type": "last"},
    "pool-none": {"pool_type": "none"},
    "proj-none": {"proj_type": "none"},
    "proj-bias": {"proj_bias": True},
    "proj-mlp-is-linear": {"proj_type": "mlp"},
}


@pytest.mark.parametrize("option", list(TEXT_OPTIONS))
def test_text_tower_options_match_jax(option):
    jax_pair, port = _option_pair(text=TEXT_OPTIONS[option])
    imgs, txts = _inputs(seed=8)
    (_, j_txt), (_, p_txt) = _encode_both(jax_pair, port, imgs, txts)
    for w, g in zip(j_txt, p_txt):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)
    # proj_type 'none' holds no projection; proj_bias a Linear, as the JAX Dense
    keys = {k for k in port.state_dict() if k.startswith("text_projection")}
    assert keys == {"proj-none": set(), "proj-bias": {"text_projection.weight",
                                                      "text_projection.bias"}
                    }.get(option, {"text_projection"})


def test_layer_scale_keys_convert_in_both_directions(tmp_path):
    """JAX params -> the port (strict load, in _option_pair) -> a .pt the JAX
    loader reads back to the same tree, ls_*.gamma included."""
    (_, params), port = _option_pair(vision={"ls_init_value": 0.5},
                                     text={"ls_init_value": 0.25})
    sd = port.state_dict()
    assert float(sd["visual.transformer.resblocks.1.ls_2.gamma"][0]) == 0.5
    assert float(sd["transformer.resblocks.0.ls_1.gamma"][0]) == 0.25
    path = save_pt_checkpoint(str(tmp_path / "ls.pt"), port)
    back = load_pt_checkpoint(path)
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for key, w in want:
        np.testing.assert_array_equal(np.asarray(got[key]), w, err_msg=str(key))


def test_load_weights_resizes_the_positional_embedding(port_model, tmp_path):
    """--pretrained at 64 px into --force-image-size 112: the 4 x 4 position
    grid is resampled to 7 x 7 as the JAX loader does; nothing else moves."""
    path = save_pt_checkpoint(str(tmp_path / "w.pt"), port_model)
    model, cfg, _, _ = factory.create_model_and_transforms(
        TINY, path, device="cpu", precision="fp32", force_image_size=112, seed=1)
    assert cfg.vision_cfg.grid_size == (7, 7)
    old = port_model.state_dict()
    want = jax_pos_embed.interpolate_pos_embed(
        jnp.asarray(old["visual.positional_embedding"].numpy()), (7, 7), (4, 4))
    new = model.state_dict()
    np.testing.assert_allclose(new["visual.positional_embedding"].numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    for k, v in old.items():
        if k != "visual.positional_embedding":
            assert torch.equal(new[k], v), k
    with torch.no_grad():
        pooled, tokens = model.encode_image(torch.zeros(2, 112, 112, 3))
    assert pooled.shape == (2, 128) and tokens.shape == (2, 49, 128)


def test_force_patch_dropout_reaches_the_vision_config():
    assert factory.model_config(TINY, force_patch_dropout=0.25).vision_cfg.patch_dropout == 0.25
    model, cfg = factory.create_model(TINY, "cpu", torch.float32, force_patch_dropout=0.25)
    assert cfg.vision_cfg.patch_dropout == 0.25
    assert isinstance(model.visual.patch_dropout, port_layers.PatchDropout)
    assert model.visual.patch_dropout.prob == 0.25
    plain, _ = factory.create_model(TINY, "cpu", torch.float32)
    assert not hasattr(plain.visual, "patch_dropout")
    assert list(model.state_dict()) == list(plain.state_dict())   # it holds no parameter


def test_unported_tower_options_still_raise():
    """``embed_cls`` is the CoCa text tower's (models/coca.py), as in JAX,
    where only CoCaTextTower reads it: the CLIP text tower refuses it."""
    cfg = factory.model_config(TINY)
    cfg.text_cfg.embed_cls = True
    with pytest.raises(NotImplementedError, match="embed_cls.*models/coca.py"):
        ColXLIP(cfg, dtype=torch.float32)



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
