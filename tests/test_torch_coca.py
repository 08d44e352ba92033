"""The port's CoCa slice against the JAX package on ``coca-S-test``: the
forward dict, ``AttentionalPooler``, the CLS mask of the text tower, the
caption CE and the streaming vocab CE (value, dh, dW; B L not a multiple of
the chunk), a coca train step under ``ce_impl`` dense and fused, the
``accum_freq=2`` splice at a microbatch as large as the decoder width,
greedy captions token for token, the sampling structure of 'top_k' and
'top_p', ``tokens_to_text``, and the decoder and text-tower keys fed back
through the JAX importer.

fp32, the same seeded numpy inputs and the same weights (JAX init ->
``convert.state_dict_from_jax_params`` -> strict load); both sides with
``COLXLIP_GELU_IMPL=stock`` (exact erf). Tolerances: features, logits and
hidden states 1e-4 absolute (fp32 sums through a vision tower, a text
tower and a decoder in another order); losses 1e-5 relative; each gradient
within 1e-4 of its largest magnitude (1e-5 for the CE functions alone), the
magnitude taken at least 1e-3 of the step's largest gradient (the key
projection's bias of an attention gets a gradient of zero by construction,
a softmax ignoring a constant a row, so its values are rounding noise);
greedy tokens equal.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from colxlip_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.losses.coca import caption_cross_entropy as jax_caption_ce
from colxlip_tpu.models.coca import CoCa as JaxCoCa
from colxlip_tpu.models.coca import MultimodalCfg as JaxMultimodalCfg
from colxlip_tpu.models.configs import CLIPCfg as JaxCLIPCfg
from colxlip_tpu.models.layers import AttentionalPooler as JaxPooler
from colxlip_tpu.ops.vocab_ce import streaming_vocab_ce as jax_vocab_ce
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.serving import generate as jax_generate
from colxlip_tpu.training.checkpoint import convert_openclip_state_dict
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.data.tokenizer import SimpleTokenizer
from colxlip_tpu_torch.losses import caption_cross_entropy
from colxlip_tpu_torch.models.coca import CoCa, cls_mask
from colxlip_tpu_torch.models.configs import CLIPCfg, MultimodalCfg
from colxlip_tpu_torch.models.layers import AttentionalPooler
from colxlip_tpu_torch.ops.vocab_ce import streaming_vocab_ce
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.serving import generate
from colxlip_tpu_torch.training import optim

MODEL = "coca-S-test"
CTX = 32
ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
CE_GRAD_REL = 1e-5
STEP_GRAD_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def _exact_gelu(monkeypatch):
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params as numpy, the port's model on those weights)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("COLXLIP_GELU_IMPL", "stock")
    jmodel, _ = jax_create_model(MODEL, precision="fp32")
    imgs, txts = _batch(0, b=1)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.asarray(imgs), jnp.asarray(txts)))
    yield jmodel, params, _port(params)
    mp.undo()


def _port(params, cfg=None, mcfg=None):
    if cfg is None:
        model, _ = factory.create_model(MODEL, "cpu", torch.float32)
    else:
        model = CoCa(cfg, mcfg, dtype=torch.float32)
    sd = convert.state_dict_from_jax_params(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _batch(seed, b=3, ctx=CTX, size=64):
    """Seeded images and ids: SOT, content, EOT at a row's own place, pads
    after it, and one pad inside the content of row 1."""
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    txts = np.zeros((b, ctx), np.int32)
    txts[:, 0] = 49406
    for i in range(b):
        end = 6 + 3 * i % (ctx - 8)
        txts[i, 1:end] = rng.integers(1, 49000, end - 1)
        txts[i, end] = 49407
    if b > 1:
        txts[1, 3] = 0
    return imgs, txts


def _close(got, want, atol=ATOL, msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def _grad_close(got, want, rel, msg=""):
    want = np.asarray(want)
    _close(got, want, rel * max(np.abs(want).max(), 1e-12), msg)


def test_forward_dict_matches_jax(pair):
    jmodel, params, model = pair
    imgs, txts = _batch(1)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(imgs), jnp.asarray(txts))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(txts).long())
        fused = model(torch.from_numpy(imgs), torch.from_numpy(txts).long(), logits=False)
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, msg=k)
    assert fused["logits"] is None and torch.equal(fused["caption_hidden"], got["caption_hidden"])
    # the decoder's width is the text's; the head is the decoder's text_projection
    assert got["caption_head_kernel"] is model.text_decoder.text_projection


def test_attentional_pooler_matches_jax():
    """d_model 32 over keys of width 48 (the CoCa pooler's case), 4 heads,
    5 queries."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    jpool = JaxPooler(d_model=32, n_head=4, n_queries=5, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jpool.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jpool.apply(params, jnp.asarray(x))
    sd, unmapped = {}, []
    convert._attn_pool(params["params"], "", sd, unmapped)
    pool = AttentionalPooler(32, 48, 4, 5, dtype=torch.float32)
    pool.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    assert not unmapped
    with torch.no_grad():
        _close(pool(torch.from_numpy(x)), want, 1e-5)


def test_cls_mask_rows_and_text_tower_match_jax(pair):
    """Text rows are purely causal; only the appended CLS row hides pad keys,
    with the reference's one-position shift (key k hidden where text[k-1] is
    pad). Pooled and token features of texts with pads (one inside the
    content) equal the JAX tower's."""
    text = torch.tensor([[49406, 5, 0, 7, 49407, 0, 0]])
    mask = cls_mask(text, 0)[0, 0]
    n = text.shape[1]
    causal = torch.full((n + 1, n + 1), float("-inf")).triu(1)
    assert torch.equal(mask[:n], causal[:n])
    hidden = [k for k in range(n + 1) if mask[n, k] == float("-inf")]
    assert hidden == [3, 6, 7]                     # keys after the pads at 2, 5 and 6
    jmodel, params, model = pair
    _, txts = _batch(4)
    want = jax.jit(lambda p, t: jmodel.apply(
        p, t, method=lambda m, t: m.encode_text(t, normalize=False)))(params, jnp.asarray(txts))
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(txts).long())
    for g, w, name in zip(got, want, ("pooled", "tokens")):
        _close(g, w, msg=name)


def _ce_case(seed=3, b=3, length=7, d=16, v=50):
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((b, length, d)) * 0.5).astype(np.float32)
    kernel = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    labels = rng.integers(1, v, (b, length)).astype(np.int32)
    labels[:, -2:] = 0
    labels[1, 2] = 0
    return hidden, kernel, labels


def test_caption_cross_entropy_matches_jax():
    hidden, kernel, labels = _ce_case()
    logits = hidden @ kernel
    want, want_g = jax.value_and_grad(lambda x: jax_caption_ce(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = caption_cross_entropy(x, torch.from_numpy(labels).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _grad_close(x.grad, want_g, CE_GRAD_REL)


@pytest.mark.parametrize("chunk", [8, 1024])
def test_streaming_vocab_ce_matches_jax(chunk):
    """21 rows: 8 pads them to 24 (three chunks), 1024 to one chunk of 1024."""
    hidden, kernel, labels = _ce_case()
    want, want_g = jax.value_and_grad(
        lambda h, k: jax_vocab_ce(h, k, jnp.asarray(labels), 0, chunk), argnums=(0, 1))(
            jnp.asarray(hidden), jnp.asarray(kernel))
    h = torch.from_numpy(hidden).requires_grad_()
    k = torch.from_numpy(kernel).requires_grad_()
    got = streaming_vocab_ce(h, k, torch.from_numpy(labels).long(), 0, chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _grad_close(h.grad, want_g[0], CE_GRAD_REL, "dh")
    _grad_close(k.grad, want_g[1], CE_GRAD_REL, "dW")
    dense = caption_cross_entropy(torch.from_numpy(hidden @ kernel),
                                  torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.item(), dense.item(), rtol=LOSS_RTOL)


def _recorder():
    """An optax transformation whose state becomes the gradients it is fed."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _steps_match(jmodel, params, model, imgs, txts, **kw):
    tx = _recorder()
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    step = jax_ts.make_train_step(jmodel, tx, jax_ts.TrainStepConfig(loss_type="coca", **kw),
                                  donate=False)
    new_state, metrics = step(state, jnp.asarray(imgs), jnp.asarray(txts))
    want_g = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, new_state.opt_state))
    model.train()
    got = make_train_step(model, optim.create_optimizer(model, 1e-3), None,
                          TrainStepConfig(loss_type="coca", **kw))(
        torch.from_numpy(imgs), torch.from_numpy(txts).long())
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    floor = STEP_GRAD_FLOOR * max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        _close(named[k].grad, w, GRAD_REL * max(np.abs(w).max(), floor), k)
    return got


@pytest.mark.parametrize("ce_impl", ["dense", "fused"])
def test_coca_step_matches_jax(pair, ce_impl):
    jmodel, params, _ = pair
    imgs, txts = _batch(5, b=4)
    _steps_match(jmodel, params, _port(params), imgs, txts, ce_impl=ce_impl)


def test_accum_freq_2_splices_batch_outputs_only():
    """accum_freq=2 at a microbatch of 16 on a CoCa whose decoder is 16 wide
    (vocab cut to 500), with the streaming caption CE: caption_head_kernel
    [16, 500] has the microbatch's leading size and must not be spliced (it
    is a weight, which the loss multiplies), while the hidden states and
    labels are. Held against the JAX step."""
    cfg = JaxCLIPCfg.from_dict({
        "embed_dim": 16,
        "vision_cfg": {"image_size": 32, "layers": 1, "width": 16, "head_width": 8,
                       "patch_size": 16, "attentional_pool": True, "attn_pooler_heads": 2,
                       "attn_pooler_queries": 4},
        "text_cfg": {"context_length": 8, "vocab_size": 500, "width": 16, "heads": 2,
                     "layers": 1, "embed_cls": True}})
    mm = dict(context_length=8, width=16, heads=2, layers=1)
    jmodel = JaxCoCa(cfg, JaxMultimodalCfg(**mm), dtype=jnp.float32)
    rng = np.random.default_rng(6)
    imgs = rng.standard_normal((32, 32, 32, 3)).astype(np.float32)
    txts = np.zeros((32, 8), np.int32)            # ids of the cut vocabulary, pads after
    for i, length in enumerate(rng.integers(2, 8, 32)):
        txts[i, :length] = rng.integers(1, 500, length)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.asarray(imgs[:1]), jnp.asarray(txts[:1])))
    pcfg = CLIPCfg.from_dict(dataclasses.asdict(cfg))
    model = _port(params, pcfg, MultimodalCfg(**mm))
    got = _steps_match(jmodel, params, model, imgs, txts, ce_impl="fused", accum_freq=2)
    assert model.text_decoder.text_projection.grad.shape == (16, 500)
    assert np.isfinite(float(got["caption_loss"]))


def test_greedy_captions_match_jax(pair):
    """Greedy decoding over the whole context: the tokens equal the JAX
    decode's; the first step is the argmax of caption_logits on [SOT]."""
    jmodel, params, model = pair
    imgs, _ = _batch(7, b=3)
    want = jax_generate.generate_captions(jmodel, params, jnp.asarray(imgs))
    got = generate.generate_captions(model, imgs)
    assert got.dtype == np.int32 and got.shape == (3, CTX)
    np.testing.assert_array_equal(got, want)
    buf = torch.zeros((3, CTX), dtype=torch.long)
    buf[:, 0] = generate.SOT
    with torch.no_grad():
        first = model.caption_logits(buf, model.embed_images(torch.from_numpy(imgs)))[:, 0]
    np.testing.assert_array_equal(got[:, 1], first.argmax(-1).numpy())
    np.testing.assert_array_equal(generate.generate_captions(model, imgs, max_len=5)[:, :5],
                                  got[:, :5])
    assert (generate.generate_captions(model, imgs, max_len=5)[:, 5:] == 0).all()
    with pytest.raises(ValueError, match="unknown decode method"):
        generate.generate_captions(model, imgs, method="beam")


def test_pads_follow_eot(pair, monkeypatch):
    """A row that emits EOT emits pads after it while the other rows go on:
    the head is pushed to EOT for row 0 at step 3."""
    _, _, model = pair
    imgs, _ = _batch(8, b=2)
    calls, real = [], model.vocab_logits

    def head(hidden):
        logits = real(hidden)
        calls.append(1)
        if hidden.ndim == 2 and len(calls) == 3:
            logits[0, generate.EOT] = 1e4
        return logits
    monkeypatch.setattr(model, "vocab_logits", head)
    tokens = generate.generate_captions(model, imgs, max_len=10)
    assert tokens[0, 3] == generate.EOT and (tokens[0, 4:] == 0).all()
    assert (tokens[1, 1:10] != 0).all()


@pytest.mark.parametrize("method", ["top_k", "top_p"])
def test_sampling_structure(pair, method):
    """Each sampled token lies in the top-k set of its step's logits (for
    top_p, in the nucleus inside it); the same seed repeats the tokens and
    another seed changes them."""
    _, _, model = pair
    imgs, _ = _batch(9, b=3)
    top_k, top_p, temperature = 20, 0.5, 2.0
    kw = dict(method=method, top_k=top_k, top_p=top_p, temperature=temperature, max_len=12)
    tokens = generate.generate_captions(model, imgs, seed=1, **kw)
    np.testing.assert_array_equal(generate.generate_captions(model, imgs, seed=1, **kw), tokens)
    assert not np.array_equal(generate.generate_captions(model, imgs, seed=2, **kw), tokens)
    with torch.no_grad():        # causal: one call gives every step's logits
        logits = model.caption_logits(torch.from_numpy(tokens).long(),
                                      model.embed_images(torch.from_numpy(imgs))).float()
    for r in range(tokens.shape[0]):
        for t in range(1, 12):
            vals, idx = torch.topk(logits[r, t - 1] / temperature, top_k)
            allowed = idx
            if method == "top_p":
                probs = torch.softmax(vals, -1)
                allowed = idx[probs.cumsum(-1) - probs < top_p]
                assert len(allowed) < top_k
            assert int(tokens[r, t]) in allowed.tolist(), (r, t)


def test_tokens_to_text_matches_jax():
    port_tok, jax_tok = SimpleTokenizer(context_length=16), JaxTokenizer(context_length=16)
    ids = jax_tok(["a dog on grass", "two cats, one hat!", "café"])
    got = generate.tokens_to_text(ids, port_tok)
    assert got == jax_generate.tokens_to_text(ids, jax_tok)
    assert got[0] == "a dog on grass"
    np.testing.assert_array_equal(port_tok(got), ids)


def test_decoder_and_text_keys_go_back_through_the_jax_importer(pair):
    """The port's state dict, fed to the JAX package's
    convert_openclip_state_dict, gives back the JAX subtrees of the text
    tower, the decoder and the vocab head exactly (q / k / v split from the
    packed in_proj)."""
    _, params, model = pair
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back = convert_openclip_state_dict(sd)["params"]
    for name in ("text", "text_decoder", "to_logits"):
        want = jax.tree_util.tree_leaves_with_path(params["params"][name])
        got = dict(jax.tree_util.tree_leaves_with_path(back[name]))
        assert len(got) == len(want), name
        for path, w in want:
            np.testing.assert_array_equal(got[path], w, err_msg=f"{name} {path}")
