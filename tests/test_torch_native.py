"""The port's native C++ core (``colxlip_tpu_torch/native``: its own copies
of ``dataloader.cc`` and ``bpe_tokenizer.cc``) against the JAX package's
build of its sources, on the same inputs: decode, crop, resize and
normalize (float32 and uint8), corrupt samples, the YUV420 conversion, and
the BPE ids against the pure-Python tokenizer. Every comparison is exact,
but the decode against PIL's, held to the JAX bar (RMS under 12 pixel
units). The port raises when its core cannot build; the JAX package falls
back.
"""
from __future__ import annotations

import io
import threading

import numpy as np
import pytest
from PIL import Image

from colxlip_tpu import native as jax_native
from colxlip_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from colxlip_tpu_torch import native
from colxlip_tpu_torch.data import wds
from colxlip_tpu_torch.data.tokenizer import SimpleTokenizer
from colxlip_tpu_torch.data.transforms import (OPENAI_DATASET_MEAN, OPENAI_DATASET_STD,
                                               image_transform)
from colxlip_tpu_torch.ops import yuv420

CORPUS = [
    "a photo of a dog",
    "Hello, World!  multiple   spaces\tand tabs",
    "it's don't we're you've i'm we'll she'd",
    "numbers 1234567890 and mixed a1b2c3",
    "",
    "   leading and trailing   ",
    "x" * 400 + " truncation forces the EOT into the last slot " + "y" * 200,
    "quotes \"double\" and 'single' (parens) [brackets] {braces}",
    "café au lait",
    "<|startoftext|> literal specials <|endoftext|>",
    "html &amp; entities",
    "emoji \U0001f600 test",
]
MERGES = ["t h", "i n", "a n", "r e", "o n", "e r", "th e</w>", "in g</w>", "an d</w>",
          "s </w>", "e </w>", "d </w>", "o f</w>", "p h", "ph o", "pho t", "phot o</w>",
          "d o", "do g</w>", "1 2", "12 3", "' s</w>"]


def _jpeg(rng, w, h, quality=90):
    coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(buf, format="JPEG",
                                                                 quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jpegs():
    rng = np.random.default_rng(0)
    return [_jpeg(rng, int(w), int(h)) for w, h in rng.integers(40, 200, (6, 2))]


def _python_rows(tok, texts):
    out = np.zeros((len(texts), tok.context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(t) + [tok.eot_token]
        if len(ids) > tok.context_length:
            ids = ids[:tok.context_length]
            ids[-1] = tok.eot_token
        out[i, :len(ids)] = ids
    return out


def test_jpeg_info_matches_jax(jpegs):
    for data in [*jpegs, b"not a jpeg", jpegs[0][:40]]:
        assert native.jpeg_info(data) == jax_native.jpeg_info(data)
    assert native.libjpeg_present()


@pytest.mark.parametrize("normalize", [True, False], ids=["float32", "uint8"])
@pytest.mark.parametrize("crops", [False, True], ids=["eval", "crops"])
def test_process_batch_is_bit_equal_to_the_jax_build(jpegs, normalize, crops):
    """Eval-style and cropped decodes, with a corrupt sample in the batch
    (its slot zeroed, counted in the failures)."""
    batch = [*jpegs[:3], b"\xff\xd8garbage", *jpegs[3:]]
    boxes = None
    if crops:
        rng = np.random.default_rng(1)
        boxes = np.array([[int(rng.integers(0, 10)), int(rng.integers(0, 10)), 30, 28]
                          for _ in batch], np.int32)
    kw = dict(crops=boxes, num_threads=3, normalize=normalize)
    got, got_fail = native.process_batch(batch, (32, 48), OPENAI_DATASET_MEAN,
                                         OPENAI_DATASET_STD, **kw)
    want, want_fail = jax_native.process_batch(batch, (32, 48), OPENAI_DATASET_MEAN,
                                               OPENAI_DATASET_STD, **kw)
    assert got.dtype == want.dtype == (np.float32 if normalize else np.uint8)
    assert got_fail == want_fail == 1
    np.testing.assert_array_equal(got, want)
    assert not got[3].any()


def _rms_pixels(got, want):
    return float(np.sqrt(np.mean(((got - want) * np.asarray(OPENAI_DATASET_STD) * 255) ** 2)))


def test_native_decode_is_close_to_the_pil_transform():
    """The JAX bar (tests/test_native.py): RMS under 12 pixel units against
    the PIL transform, decode and resample differing: the eval path on the
    JAX test's noise image, and the train path on the seeded shards' photos
    (shard_writer) on the same RandomResizedCrop boxes."""
    import random

    from colxlip_tpu_torch.data import shard_writer, transforms

    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray((rng.random((160, 200, 3)) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=95)
    out, failures = native.process_batch([buf.getvalue()], (64, 64), OPENAI_DATASET_MEAN,
                                         OPENAI_DATASET_STD)
    want = image_transform(64, is_train=False, interpolation="bilinear")(
        Image.open(io.BytesIO(buf.getvalue())))
    assert failures == 0 and _rms_pixels(out[0], want) < 12.0
    train = image_transform(64, is_train=True)
    for i in range(4):
        h, w = (int(x) for x in rng.integers(64, 97, 2))
        data = shard_writer.seeded_jpeg(rng, h, w, 95)
        box = transforms.sample_rrc_box(w, h, rng=random.Random(i))
        out, failures = native.process_batch([data], (64, 64), OPENAI_DATASET_MEAN,
                                             OPENAI_DATASET_STD,
                                             crops=np.array([box], np.int32))
        want = train(Image.open(io.BytesIO(data)), rng=random.Random(i))
        assert failures == 0 and _rms_pixels(out[0], want) < 12.0


def test_rgb_to_yuv420_native_numpy_and_jax_agree():
    rgb = np.random.default_rng(2).integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
    got = native.rgb_to_yuv420(rgb)
    np.testing.assert_array_equal(got, jax_native.rgb_to_yuv420(rgb))
    np.testing.assert_array_equal(got, yuv420.rgb_to_yuv420(rgb))
    with pytest.raises(ValueError, match="even"):
        native.rgb_to_yuv420(rgb[:, :15])


@pytest.mark.parametrize("with_merges", [False, True], ids=["zero-merges", "merges"])
def test_native_tokenizer_ids_equal_the_python_path_and_jax(tmp_path, monkeypatch,
                                                            with_merges):
    kw = {}
    if with_merges:
        path = tmp_path / "merges.txt"
        path.write_text("#version: synthetic\n" + "\n".join(MERGES) + "\n")
        monkeypatch.setenv("COLXLIP_BPE_PATH", str(path))
        kw = {"bpe_path": str(path)}
    tok = SimpleTokenizer(context_length=64)
    assert tok.has_merges == with_merges
    got = tok(CORPUS)
    assert tok._get_native() is not None         # the native core took the ASCII rows
    np.testing.assert_array_equal(got, _python_rows(tok, CORPUS))
    np.testing.assert_array_equal(got, JaxTokenizer(context_length=64, **kw)(CORPUS))
    monkeypatch.setenv("COLXLIP_NATIVE_TOKENIZER", "0")
    python_only = SimpleTokenizer(context_length=64)
    assert python_only._get_native() is None
    np.testing.assert_array_equal(python_only(CORPUS), got)


def test_native_tokenizer_is_thread_safe():
    """Loader threads share one tokenizer: one handle, equal rows from each."""
    tok = SimpleTokenizer(context_length=32)
    texts = [f"the photo {i} of dog {i * 7919 % 97} and thing{i}" for i in range(128)]
    want = tok(texts)
    results, errors = [None] * 6, []

    def work(slot):
        try:
            for _ in range(5):
                results[slot] = tok(texts)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    for r in results:
        np.testing.assert_array_equal(r, want)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})


@pytest.mark.parametrize("how", ["empty-path", "no-such-compiler", "compiler-fails"])
def test_the_core_raises_when_it_cannot_build(fresh_build, monkeypatch, how):
    """No fallback: the decoder, the pipeline that asks for it and the
    tokenizer each raise, with the compiler's complaint."""
    if how == "empty-path":
        monkeypatch.setenv("PATH", "")
        message = "cannot run"
    elif how == "no-such-compiler":
        monkeypatch.setattr(native, "CXX", "no-such-compiler-cx")
        message = "cannot run"
    else:
        monkeypatch.setattr(native, "CXX", "false")
        message = "failed"
    with pytest.raises(RuntimeError, match=message):
        native.load("dataloader")
    with pytest.raises(RuntimeError, match=message):
        wds.WdsTrainPipeline(wds.WdsConfig(urls="none-{0..1}.tar", native_decode=True),
                             image_transform(32, is_train=True), None)
    monkeypatch.delenv("COLXLIP_NATIVE_TOKENIZER", raising=False)
    with pytest.raises(RuntimeError, match=message):
        SimpleTokenizer(context_length=16)(["a photo"])
    assert not native.libjpeg_present()


def test_the_build_goes_to_the_ports_own_tree(fresh_build):
    for name in ("dataloader", "bpe_tokenizer"):
        lib = native.build(name)
        assert lib.parent == native.BUILD_DIR and lib.exists()
        assert native.library_path(name) == lib
        assert (native.NATIVE_DIR / f"{name}.cc").is_file()
    assert "colxlip_tpu_torch" in native.NATIVE_DIR.parts
