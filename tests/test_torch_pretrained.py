"""The pretrained tag registry (``colxlip_tpu_torch/pretrained.py``) and
``create_model_and_transforms(pretrained=<tag>)`` against the JAX package,
with no network: a tag resolves through a cached file, a ``file://`` URL in a
monkeypatched registry, or the offline error."""
from __future__ import annotations

import logging
import os

import pytest
import torch

from colxlip_tpu import pretrained as jax_pretrained
from colxlip_tpu_torch import factory, pretrained
from colxlip_tpu_torch.training.checkpoint import save_pt_checkpoint

TINY = "ViT-S-16-test"


def test_registry_equals_jax():
    assert pretrained.PRETRAINED == jax_pretrained.PRETRAINED
    assert pretrained.QUICK_GELU_TAGS == jax_pretrained.QUICK_GELU_TAGS
    assert pretrained.list_pretrained() == jax_pretrained.list_pretrained()
    for model in ("ViT-B-16", "ViT-B-16-colxlip", "ViT-B-32-quickgelu", "ViT-L-14-colxlip",
                  "coca_ViT-B-32", "RN50"):
        for tag in ("openai", "laion400m_e32", "laion2b_s34b_b88k", "nope"):
            assert (pretrained.get_pretrained_url(model, tag)
                    == jax_pretrained.get_pretrained_url(model, tag)), (model, tag)


def test_resolution_order_and_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("COLXLIP_CACHE", str(tmp_path / "cache"))
    assert pretrained.cache_dir() == str(tmp_path / "cache")
    local = tmp_path / "weights.pt"
    local.write_bytes(b"x")
    assert pretrained.resolve_pretrained("ViT-B-16", str(local)) == str(local)
    # a cached file is used as it is: no fetch
    url = pretrained.get_pretrained_url("ViT-B-16-colxlip", "laion400m_e32")
    cached = tmp_path / "cache" / os.path.basename(url)
    cached.parent.mkdir()
    cached.write_bytes(b"cached")

    def no_fetch(*a, **k):
        raise AssertionError("a cached checkpoint must not be fetched")

    monkeypatch.setattr("urllib.request.urlretrieve", no_fetch)
    assert pretrained.resolve_pretrained("ViT-B-16-colxlip", "laion400m_e32") == str(cached)
    with pytest.raises(FileNotFoundError, match="neither a local path nor a known tag") as got:
        pretrained.resolve_pretrained("ViT-B-16", "no-such-tag")
    with pytest.raises(FileNotFoundError) as want:
        jax_pretrained.resolve_pretrained("ViT-B-16", "no-such-tag")
    assert str(got.value) == str(want.value)


def test_file_url_fetch_and_offline_error(tmp_path, monkeypatch):
    monkeypatch.setenv("COLXLIP_CACHE", str(tmp_path / "cache"))
    source = tmp_path / "served" / "tiny-e1.pt"
    source.parent.mkdir()
    source.write_bytes(b"weights")
    monkeypatch.setitem(pretrained.PRETRAINED, TINY, {"e1": source.as_uri()})
    got = pretrained.resolve_pretrained(TINY, "e1")
    assert got == str(tmp_path / "cache" / "tiny-e1.pt")
    with open(got, "rb") as f:
        assert f.read() == b"weights"
    assert not os.path.exists(got + ".tmp")
    # offline: the error names where to place the file, and leaves no file
    gone = (tmp_path / "served" / "missing.pt").as_uri()
    monkeypatch.setitem(pretrained.PRETRAINED, TINY, {"e2": gone})
    where = str(tmp_path / "cache" / "missing.pt")
    with pytest.raises(RuntimeError, match=f"place the file at {where} manually"):
        pretrained.resolve_pretrained(TINY, "e2")
    assert not os.path.exists(where)


def test_create_model_resolves_a_tag_and_warns_on_quick_gelu(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("COLXLIP_CACHE", str(tmp_path / "cache"))
    weights, _ = factory.create_model(TINY, "cpu", torch.float32, seed=9)
    served = save_pt_checkpoint(str(tmp_path / "tiny-openai.pt"), weights)
    monkeypatch.setitem(pretrained.PRETRAINED, TINY, {"openai": f"file://{served}",
                                                      "e1": f"file://{served}"})
    with caplog.at_level(logging.WARNING, logger="colxlip_tpu_torch.factory"):
        model, cfg, _, _ = factory.create_model_and_transforms(
            TINY, pretrained="openai", device="cpu", precision="fp32")
    assert "trained with QuickGELU but this model config has quick_gelu=False" in caplog.text
    for k, v in weights.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="colxlip_tpu_torch.factory"):
        factory.create_model_and_transforms(TINY, pretrained="e1", device="cpu",
                                            precision="fp32")
        factory.create_model_and_transforms(TINY, pretrained="openai", device="cpu",
                                            precision="fp32", quick_gelu=True)
    assert "QuickGELU" not in caplog.text
