"""colxlip_tpu_torch retrieval index against the JAX package's, on the CPU:
the same seeded corpus through both ``IndexWriter``s (files byte-equal, each
index opens in the other package), ``RetrievalIndex.search`` against the JAX
search (same indices, scores within 1e-4 at logit scale 10: fp32 sums of
32-d unit-norm token products in another order), and ``build_image_index``
through the port's tiny model.
"""
from __future__ import annotations

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from colxlip_tpu.serving.index import IndexWriter as JaxIndexWriter
from colxlip_tpu.serving.index import RetrievalIndex as JaxRetrievalIndex
from colxlip_tpu_torch import factory
from colxlip_tpu_torch.ops import maxsim as port_maxsim
from colxlip_tpu_torch.serving.index import IndexWriter, RetrievalIndex, build_image_index

TINY = "ViT-S-16-test-colxlip"
SCORE_ATOL = 1e-4
FILES = ("meta.json", "pooled.npy", "tokens.npy")


def _l2(x, axis=-1):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    """Correlated pooled/token features (pooled = mean of the tokens), so the
    global shortlist is predictive of the MaxSim order; query tokens carry an
    EOT-zeroed tail and a 'valid' mask."""
    rng = np.random.default_rng(7)
    n, li, lt, d = 40, 12, 6, 32
    tokens = _l2(rng.standard_normal((n, li, d)).astype(np.float32))
    pooled = _l2(tokens.mean(axis=1))
    q_tokens = _l2(rng.standard_normal((5, lt, d)).astype(np.float32))
    q_tokens[0] = _l2(0.9 * tokens[17, :lt] + 0.1 * q_tokens[0])
    q_tokens[1] = _l2(0.9 * tokens[3, :lt] + 0.1 * q_tokens[1])
    q_pooled = _l2(q_tokens.mean(axis=1))
    q_tokens[2, 4:] = 0.0
    mask = (np.arange(lt)[None, :] < np.array([6, 5, 4, 3, 6])[:, None]).astype(np.float32)
    return pooled, tokens, q_pooled, q_tokens, mask


def _write(writer_cls, out_dir, corpus, ids):
    pooled, tokens = corpus[:2]
    w = writer_cls(str(out_dir), model="test", logit_scale=10.0)
    names = [f"img{i:03d}" for i in range(40)]
    # two chunks: concatenation, and the id mapping when ids are given
    w.add(pooled[:25], tokens[:25], ids=names[:25] if ids else None)
    w.add(pooled[25:], tokens[25:], ids=names[25:] if ids else None)
    return w.finalize()


@pytest.fixture(scope="module", params=["ids", "no-ids"])
def indexes(request, tmp_path_factory, corpus):
    """(directory written by the port, directory written by the JAX package)."""
    ids = request.param == "ids"
    base = tmp_path_factory.mktemp("idx")
    return (_write(IndexWriter, base / "port", corpus, ids),
            _write(JaxIndexWriter, base / "jax", corpus, ids), ids)


def test_index_files_are_byte_equal(indexes):
    port_dir, jax_dir, _ = indexes
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == sorted(FILES)
    for name in FILES:
        assert filecmp.cmp(os.path.join(port_dir, name), os.path.join(jax_dir, name),
                           shallow=False), name


def test_each_package_opens_the_others_index(indexes, corpus):
    port_dir, jax_dir, ids = indexes
    pooled, tokens = corpus[:2]
    ours, theirs = RetrievalIndex(jax_dir, device="cpu"), JaxRetrievalIndex(port_dir)
    for idx in (ours, theirs):
        assert len(idx) == 40 and idx.logit_scale == 10.0
        assert idx.meta["embed_dim"] == 32 and idx.meta["token_len"] == 12
        assert idx.meta["dtype"] == "float16" and idx.meta["model"] == "test"
        assert (idx.ids is not None) == ids
        assert isinstance(idx.tokens, np.memmap) and idx.tokens.dtype == np.float16
        np.testing.assert_allclose(np.asarray(idx.pooled, np.float32), pooled, atol=1e-3)
        np.testing.assert_allclose(np.asarray(idx.tokens, np.float32), tokens, atol=1e-3)
    assert ours.device == torch.device("cpu")


@pytest.mark.parametrize("scoring", ["global", "maxsim", "mixed"])
@pytest.mark.parametrize("shortlist", [8, 100])
def test_search_matches_the_jax_search(indexes, corpus, scoring, shortlist):
    port_dir, jax_dir, ids = indexes
    _, _, q_pooled, q_tokens, _ = corpus
    kwargs = dict(k=5, shortlist=shortlist, scoring=scoring, alpha=0.3)
    want = JaxRetrievalIndex(jax_dir).search(q_pooled, q_tokens, **kwargs)
    for directory in (port_dir, jax_dir):
        got = RetrievalIndex(directory, device="cpu").search(q_pooled, q_tokens, **kwargs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=SCORE_ATOL)
        assert got[1].dtype == np.float32 and got[0].shape == (5, 5)
        assert got[2] == want[2]
        assert (got[2] is not None) == ids
        if ids:
            assert got[2][0][0] == f"img{int(got[0][0, 0]):03d}"
    if scoring != "global":
        assert got[0][0, 0] == 17 and got[0][1, 0] == 3       # the biased queries


@pytest.mark.parametrize("mode", ["nonzero", "plain", "valid"])
def test_full_shortlist_equals_brute_force(indexes, corpus, mode):
    """shortlist >= N: every item is reranked, so the result is the brute-force
    MaxSim ranking of the stored (fp16) tokens; the 'valid' mask reaches it."""
    port_dir, _, _ = indexes
    _, _, q_pooled, q_tokens, mask = corpus
    idx = RetrievalIndex(port_dir, device="cpu")
    got_idx, got_scores, _ = idx.search(q_pooled, q_tokens, k=40, shortlist=10_000,
                                        mask_mode=mode, text_mask=mask)
    stored = torch.from_numpy(np.asarray(idx.tokens, np.float32))
    brute = 10.0 * port_maxsim.maxsim_plain(
        torch.from_numpy(q_tokens), stored, mask_mode=mode,
        text_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got_idx, np.argsort(-brute, axis=1, kind="stable"))
    np.testing.assert_allclose(got_scores, -np.sort(-brute, axis=1), atol=1e-5)
    want = JaxRetrievalIndex(port_dir).search(q_pooled, q_tokens, k=40, shortlist=10_000,
                                              mask_mode=mode, text_mask=mask)
    np.testing.assert_array_equal(got_idx, want[0])
    np.testing.assert_allclose(got_scores, want[1], atol=SCORE_ATOL)


def test_search_accepts_maxsim_impl_streaming_int8(indexes, corpus):
    port_dir, jax_dir, _ = indexes
    _, _, q_pooled, q_tokens, _ = corpus
    kwargs = dict(k=5, shortlist=40, scoring="maxsim", maxsim_impl="streaming_int8")
    got = RetrievalIndex(port_dir, device="cpu").search(q_pooled, q_tokens, **kwargs)
    want = JaxRetrievalIndex(jax_dir).search(q_pooled, q_tokens, **kwargs)
    default = RetrievalIndex(port_dir, device="cpu").search(q_pooled, q_tokens, k=5,
                                                           shortlist=40)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_allclose(np.sort(got[1]), np.sort(want[1]), atol=SCORE_ATOL)
    # int8 noise on scores scaled by 10: under 0.2, and not nothing
    assert 0 < np.abs(got[1] - default[1]).max() < 0.2


def test_search_errors(indexes, corpus, tmp_path):
    port_dir, _, _ = indexes
    _, _, q_pooled, q_tokens, _ = corpus
    idx = RetrievalIndex(port_dir, device="cpu")
    with pytest.raises(ValueError, match="needs query_tokens"):
        idx.search(q_pooled, None, scoring="maxsim")
    with pytest.raises(ValueError, match="unknown scoring"):
        idx.search(q_pooled, q_tokens, scoring="best")
    with pytest.raises(ValueError, match=r"\[M, D\]"):
        idx.search(q_pooled[0], q_tokens)
    with pytest.raises(ValueError, match="unknown impl"):
        idx.search(q_pooled, q_tokens, maxsim_impl="int8")
    # k and shortlist are cut to the corpus
    got = idx.search(q_pooled, q_tokens, k=1000, shortlist=3)
    assert got[0].shape == (5, 40)
    with pytest.raises(ValueError, match="empty index"):
        IndexWriter(str(tmp_path / "e")).finalize()
    w = IndexWriter(str(tmp_path / "w"))
    with pytest.raises(ValueError, match="expected pooled"):
        w.add(np.zeros((2, 4)), np.zeros((3, 5, 4)))
    with pytest.raises(ValueError, match="ids length"):
        w.add(np.zeros((2, 4)), np.zeros((2, 5, 4)), ids=["a"])
    w.add(np.zeros((2, 4)), np.zeros((2, 5, 4)), ids=["a", "b"])
    w.add(np.zeros((1, 4)), np.zeros((1, 5, 4)))
    with pytest.raises(ValueError, match="only some batches"):
        w.finalize()
    bad = tmp_path / "bad"
    os.makedirs(bad)
    np.save(bad / "pooled.npy", np.zeros((3, 4), np.float16))
    np.save(bad / "tokens.npy", np.zeros((2, 5, 4), np.float16))
    (bad / "meta.json").write_text(json.dumps({"num_items": 3}))
    with pytest.raises(ValueError, match="corrupt index"):
        RetrievalIndex(str(bad), device="cpu")


@pytest.mark.parametrize("feed", ["float32", "uint8"])
def test_build_image_index_through_the_model(tmp_path, feed):
    """11 images in batches of 4 (the last batch padded by repeating its last
    image, the pad rows cut): the stored rows are the model's features of
    each image, in order, in fp16."""
    model, cfg = factory.create_model(TINY, "cpu", torch.float32, seed=1)
    rng = np.random.default_rng(0)
    if feed == "uint8":
        images = rng.integers(0, 256, (11, 64, 64, 3), dtype=np.uint8)
    else:
        images = rng.standard_normal((11, 64, 64, 3)).astype(np.float32)
    ids = [f"item-{i}" for i in range(11)]
    out = build_image_index(model, iter(images), str(tmp_path / "built"), device="cpu",
                            ids=ids, batch_size=4, model_name=TINY)
    idx = RetrievalIndex(out, device="cpu")
    assert len(idx) == 11 and idx.ids == ids and idx.meta["model"] == TINY
    assert idx.tokens.shape == (11, 16, 128) and idx.pooled.shape == (11, 128)
    assert idx.logit_scale == pytest.approx(float(np.exp(cfg.init_logit_scale)), rel=1e-6)
    with torch.no_grad():
        pooled, tokens = model.encode_image(torch.from_numpy(images), normalize=True)
    # fp16 storage of unit-norm features: 2^-11 relative, 5e-4 absolute
    np.testing.assert_allclose(np.asarray(idx.pooled, np.float32), pooled.numpy(), atol=5e-4)
    np.testing.assert_allclose(np.asarray(idx.tokens, np.float32), tokens.numpy(), atol=5e-4)
    # every image finds itself first when its own features are the query
    got = idx.search(pooled.numpy(), None, k=1, scoring="global")
    np.testing.assert_array_equal(got[0][:, 0], np.arange(11))
    assert JaxRetrievalIndex(out).meta == idx.meta


def test_build_image_index_needs_a_token_head(tmp_path):
    model, _ = factory.create_model("ViT-S-16-test", "cpu", torch.float32, seed=1)
    images = np.zeros((2, 64, 64, 3), np.float32)
    with pytest.raises(ValueError, match="token head"):
        build_image_index(model, iter(images), str(tmp_path / "x"), device="cpu", batch_size=2)
