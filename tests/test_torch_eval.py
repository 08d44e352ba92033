"""The port's eval against the JAX package, on the CPU: the retrieval metrics,
the seven readers, ``RetrievalSuite``, ``retrieval_on_split`` under every
scoring and mask mode, zero-shot, and ``main``'s eval-only mode and
epoch-end eval.

Weights come from a JAX init (``state_dict_from_jax_params``, or a ``.pt``
both packages load); images are seeded PIL JPEGs written to ``tmp_path`` at
the paths the annotations name. Both sides run ``COLXLIP_GELU_IMPL=fast9``,
the JAX default, which the port now has. Tolerances: the metrics are
compared exactly (equal dicts); the similarity matrices within 2e-4 x
logit_scale (the feature bar of ``tests/test_torch_model.py``); the
zero-shot classifier's columns at cosine >= 1 - 1e-5 and its top-1 / top-5
exactly; reader lists field by field, exactly.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from colxlip_tpu import main as jax_main
from colxlip_tpu.data import retrieval as jax_retrieval
from colxlip_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from colxlip_tpu.data.transforms import image_transform as jax_image_transform
from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.training import evaluate as jax_evaluate
from colxlip_tpu.training import zero_shot as jax_zero_shot
from colxlip_tpu.training.checkpoint import save_pt_checkpoint
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch.data import retrieval
from colxlip_tpu_torch.data.tokenizer import SimpleTokenizer
from colxlip_tpu_torch.data.transforms import image_transform
from colxlip_tpu_torch.models import ColXLIP
from colxlip_tpu_torch.training import evaluate, zero_shot

TINY = "ViT-S-16-test-colxlip"
DATASETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "datasets")
SIM_TOL = 2e-4          # x logit_scale


@pytest.fixture(autouse=True)
def _gelu_fast9(monkeypatch):
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "fast9")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _loop_oracle(i2t_sim, txt2img, img2txt):
    """The reference's loops (tests/test_eval.py ``loop_oracle``)."""
    out = {}
    t2i = i2t_sim.T
    t2i_ranks = np.array([np.where(np.argsort(-s, kind="stable") == txt2img[i])[0][0]
                          for i, s in enumerate(t2i)], np.float64)
    i2t_ranks = np.array([min(np.where(np.argsort(-s, kind="stable") == c)[0][0]
                              for c in img2txt[i]) for i, s in enumerate(i2t_sim)], np.float64)
    for pre, r in (("text_to_image", t2i_ranks), ("image_to_text", i2t_ranks)):
        out.update({f"{pre}_R@1": float((r < 1).mean()), f"{pre}_R@5": float((r < 5).mean()),
                    f"{pre}_R@10": float((r < 10).mean()),
                    f"{pre}_mean_rank": float(r.mean() + 1),
                    f"{pre}_median_rank": float(np.floor(np.median(r)) + 1)})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_bit_equal_with_planted_ties(seed):
    """Random sims with exact ties planted in rows and columns, +0.0 and
    -0.0 among them: the port's metrics equal JAX's and the loop oracle's,
    bit for bit (ties rank to the lower column)."""
    rng = np.random.default_rng(seed)
    n_img, n_txt = 23, 57
    sim = rng.integers(-3, 4, (n_img, n_txt)).astype(np.float32) / 2     # many exact ties
    sim[rng.random(sim.shape) < 0.2] = 0.0
    sim[:, 5] = -0.0
    sim[3] = sim[4]                                                       # tied rows
    sim[:, 10] = sim[:, 11]                                               # tied columns
    txt2img = {c: int(rng.integers(0, n_img)) for c in range(n_txt)}
    for i in range(n_img):                      # every image has a caption
        txt2img[i] = i
    img2txt = {}
    for c, i in txt2img.items():
        img2txt.setdefault(i, []).append(c)
    got = evaluate.compute_retrieval_metrics(sim, txt2img, img2txt)
    assert got == jax_evaluate.compute_retrieval_metrics(sim, txt2img, img2txt)
    assert got == _loop_oracle(sim, txt2img, img2txt)
    assert got["text_to_image_R@10"] < 1.0


# ---------------------------------------------------------------------------
# readers and the suite
# ---------------------------------------------------------------------------

def _examples(lst):
    return [dataclasses.astuple(e) for e in lst]


@pytest.mark.parametrize("name,reader_args", [
    ("coco", {"root_dir": "coco", "split": "val"}),
    ("flickr", {"root_dir": "flickr30k-images", "split": "val"}),
    ("urban_1k", {"root_dir": "Urban1k"}),
    ("iiw", {"root_dir": "imageinwords", "finegrained": True}),
])
def test_readers_on_the_vendored_annotations(name, reader_args):
    args = {**reader_args, "root_dir": os.path.join(DATASETS, reader_args["root_dir"])}
    got = retrieval._READERS[name](args)
    want = jax_retrieval._READERS[name](args)
    assert len(got) > 900 and _examples(got) == _examples(want)


def test_dci_reader_vendored_splits_and_a_fake_tree(tmp_path):
    """The vendored DCI tree has splits.json only: both readers fail alike.
    A fake tree with the split file's first names gives equal lists."""
    vendored = {"root_dir": os.path.join(DATASETS, "dci")}
    for reader in (retrieval.read_dci_pairs, jax_retrieval.read_dci_pairs):
        with pytest.raises(FileNotFoundError):
            reader(vendored["root_dir"])
    with open(os.path.join(DATASETS, "dci", "densely_captioned_images", "splits.json")) as f:
        splits = json.load(f)
    base = tmp_path / "densely_captioned_images"
    (base / "annotations").mkdir(parents=True)
    small = {k: v[:3] for k, v in splits.items()}
    (base / "splits.json").write_text(json.dumps(small))
    for i, fname in enumerate(n for v in small.values() for n in v):
        (base / "annotations" / fname).write_text(json.dumps({
            "image": f"img{i}.jpg", "short_caption": f"A short one {i}.",
            "extra_caption": f"More words. Then </s> another line {i}\nlast"}))
    got, want = retrieval.read_dci_pairs(str(tmp_path)), jax_retrieval.read_dci_pairs(
        str(tmp_path))
    assert len(got) == 3 * len(small) and _examples(got) == _examples(want)


def test_docci_sharegpt4v_and_iiw_readers_on_fake_files(tmp_path):
    ann = {"annotations": [{"image_id": i // 2, "image": f"d{i // 2}.jpg",
                            "caption": f"caption {i}"} for i in range(6)]}
    (tmp_path / "annotations").mkdir()
    (tmp_path / "annotations" / "test_annotations.json").write_text(json.dumps(ann))
    conv = [{"image": f"sa/images/x{i}.jpg", "conversations": [
        {"value": "q"}, {"value": f"Line one {i}. Line two\nthree</s>four."}]} for i in range(5)]
    (tmp_path / "share.json").write_text(json.dumps(conv))
    for sub, key in (("DOCCI_Test", "image"), ("IIW-400", "image/key"), ("DCI_Test", "image")):
        (tmp_path / sub).mkdir()
        lines = [json.dumps({key: f"{sub}_{i}" + (".jpg" if i % 2 else ""),
                             "IIW": f"First. Second {i}\nThird"}) for i in range(3)]
        (tmp_path / sub / "data.jsonl").write_text("\n".join(lines) + "\n")
    root = str(tmp_path)
    cases = [
        ("docci", {"root_dir": root}),
        ("sharegpt4v-1k", {"root_dir": root, "json_name": str(tmp_path / "share.json")}),
        ("sharegpt4v-10k", {"root_dir": root, "json_name": str(tmp_path / "share.json")}),
        ("iiw", {"root_dir": root}),
    ]
    for name, args in cases:
        got, want = retrieval._READERS[name](args), jax_retrieval._READERS[name](args)
        assert got and _examples(got) == _examples(want), name
    with pytest.raises(KeyError):
        retrieval.build_retrieval_suite("nope", {}, None, None)


def _write_flickr(root, n_images, seed=0, captions_per_image=3):
    """A Flickr30k-layout suite under ``root``: root/flickr30k-images/
    flickr30k_val.json and seeded JPEGs of varied sizes at its paths.
    Returns the reader's root_dir."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "flickr30k-images")
    os.makedirs(img_dir, exist_ok=True)
    words = ["dog", "cat", "red", "car", "tree", "boat", "sky", "man", "woman", "ball"]
    anns = []
    for i in range(n_images):
        h, w = (int(x) for x in rng.integers(40, 120, 2))
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, f"{i}.jpg"), quality=90)
        anns.append({"image": f"flickr30k-images/{i}.jpg", "caption": [
            " ".join(rng.choice(words, int(rng.integers(2, 9)))) + f" {i} {j}"
            for j in range(captions_per_image)]})
    with open(os.path.join(img_dir, "flickr30k_val.json"), "w") as f:
        json.dump(anns, f)
    return img_dir


@pytest.fixture(scope="module")
def flickr(tmp_path_factory):
    return _write_flickr(str(tmp_path_factory.mktemp("flickr")), 7)


def _suites(root):
    args = {"root_dir": root, "split": "val"}
    got = retrieval.build_retrieval_suite("flickr", args, SimpleTokenizer(32),
                                          image_transform(64, is_train=False))
    want = jax_retrieval.build_retrieval_suite("flickr", args, JaxTokenizer(context_length=32),
                                               jax_image_transform(64, is_train=False))
    return got, want


def test_retrieval_suite_equals_jax(flickr):
    got, want = _suites(flickr)
    assert (got.num_texts, got.num_images) == (want.num_texts, want.num_images) == (21, 7)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.image_paths == want.image_paths
    assert got.img2txt == want.img2txt and got.txt2img == want.txt2img
    for g, w in zip(got.iter_image_batches(4), want.iter_image_batches(4)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# retrieval_on_split, zero-shot
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jmodel, _ = jax_create_model(TINY, precision="fp32")
    imgs = jnp.zeros((1, 64, 64, 3), jnp.float32)
    txts = jnp.zeros((1, 32), jnp.int32).at[:, 0].set(49406).at[:, 1].set(49407)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(5), imgs, txts))
    model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
    sd = convert.state_dict_from_jax_params(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jmodel, params, model.train()


def _capture_sims(monkeypatch, module, store):
    real = module.compute_retrieval_metrics

    def capture(sim, txt2img, img2txt):
        store.append(np.array(sim))
        return real(sim, txt2img, img2txt)

    monkeypatch.setattr(module, "compute_retrieval_metrics", capture)


@pytest.mark.parametrize("mask_mode", ["nonzero", "valid"])
@pytest.mark.parametrize("scoring", ["global", "maxsim", "mixed"])
def test_retrieval_on_split_matches_jax(flickr, models, monkeypatch, scoring, mask_mode):
    jmodel, params, model = models
    suite, jsuite = _suites(flickr)
    sims, jsims = [], []
    _capture_sims(monkeypatch, evaluate, sims)
    _capture_sims(monkeypatch, jax_evaluate, jsims)
    got = evaluate.retrieval_on_split(model, suite, batch_size=4, scoring=scoring,
                                      mask_mode=mask_mode)
    want = jax_evaluate.retrieval_on_split(jmodel, params, jsuite, batch_size=4,
                                           scoring=scoring, maxsim_impl="xla",
                                           mask_mode=mask_mode)
    assert model.training                       # the Encoder restores the mode
    scale = float(np.exp(params["params"]["logit_scale"]))
    assert sims[0].shape == jsims[0].shape == (7, 21) and sims[0].dtype == np.float32
    np.testing.assert_allclose(sims[0], jsims[0], rtol=0, atol=SIM_TOL * scale)
    assert got == want
    assert got["flickr_num_text_samples"] == 21 and got["flickr_num_image_samples"] == 7


def test_encoder_keeps_features_on_the_model_device_in_fp32(flickr, models):
    _, _, model = models
    suite, _ = _suites(flickr)
    enc = evaluate.Encoder(model, batch_size=3)
    feats, toks = enc.encode_images(suite)
    assert feats.dtype == toks.dtype == torch.float32
    assert feats.shape == (7, 128) and toks.shape == (7, 16, 128)
    assert enc.seconds["total"] >= enc.seconds["load"] > 0
    tfeats, ttoks = evaluate.Encoder(model, batch_size=5, with_tokens=False).encode_texts(suite)
    assert tfeats.shape == (21, 128) and ttoks is None


def _write_imagenet(root, n_classes=6, per_class=2, seed=0, classnames=True):
    rng = np.random.default_rng(seed)
    names = [f"thing {c}" for c in range(n_classes)]
    for c in range(n_classes):
        d = os.path.join(root, f"n{c:08d}")
        os.makedirs(d)
        for j in range(per_class):
            arr = (rng.random((int(rng.integers(50, 90)), 70, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{j}.JPEG"), quality=90)
    if classnames:
        with open(os.path.join(root, "classnames.json"), "w") as f:
            json.dump(names, f)
    return names


def test_zero_shot_eval_matches_jax(tmp_path, models):
    jmodel, params, model = models
    names = _write_imagenet(str(tmp_path), n_classes=7)
    tok, jtok = SimpleTokenizer(32), JaxTokenizer(context_length=32)
    clf = zero_shot.build_zero_shot_classifier(model, tok, names)
    jclf = np.asarray(jax_zero_shot.build_zero_shot_classifier(jmodel, params, jtok, names))
    assert clf.shape == jclf.shape == (128, 7) and clf.dtype == torch.float32
    cos = (clf.numpy() * jclf).sum(0) / np.linalg.norm(jclf, axis=0)
    assert cos.min() >= 1 - 1e-5
    got = zero_shot.zero_shot_eval(model, tok, image_transform(64, is_train=False),
                                   str(tmp_path), batch_size=4)
    want = jax_zero_shot.zero_shot_eval(jmodel, params, jtok,
                                        jax_image_transform(64, is_train=False),
                                        str(tmp_path), batch_size=8)
    assert got == want and set(got) == {"imagenet-zeroshot-val-top1",
                                        "imagenet-zeroshot-val-top5"}
    assert model.training


def test_zero_shot_classnames_resolve_in_the_jax_order(tmp_path):
    from colxlip_tpu_torch.training.imagenet_classnames import IMAGENET_CLASSNAMES

    assert zero_shot.resolve_classnames(str(tmp_path)) == IMAGENET_CLASSNAMES
    (tmp_path / "classnames.json").write_text(json.dumps({"1": ["n2", "b"], "0": "a"}))
    assert zero_shot.resolve_classnames(str(tmp_path)) == ["a", "b"]
    other = tmp_path / "other.json"
    other.write_text(json.dumps(["x", "y", "z"]))
    assert zero_shot.resolve_classnames(str(tmp_path), str(other)) == ["x", "y", "z"]
    assert zero_shot.load_classnames(str(other)) == jax_zero_shot.load_classnames(str(other))


# ---------------------------------------------------------------------------
# main: eval-only and the epoch-end eval
# ---------------------------------------------------------------------------

def _eval_argv(logs, name, flickr_root, pt, *extra):
    return ["--model", TINY, "--pretrained", pt, "--allow-degraded-tokenizer",
            "--precision", "fp32", "--batch-size", "4", "--logs", str(logs), "--name", name,
            "--retrieval-flickr", "--flickr-data-root-dir", flickr_root,
            "--eval-scoring", "mixed", "--seed", "0", *extra]


def _results(logs, name):
    with open(os.path.join(logs, name, "checkpoints", "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_main_eval_only_results_equal_jax(tmp_path, flickr, models, monkeypatch):
    """Both entry points evaluate the same ``.pt`` in eval-only mode (no
    --train-data, --dataset-type auto): one results.jsonl line each, with
    the same keys and values, retrieval and zero-shot."""
    monkeypatch.setenv("JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    _, params, _ = models
    pt = save_pt_checkpoint(str(tmp_path / "w.pt"), params)
    val = tmp_path / "val"
    _write_imagenet(str(val), n_classes=5, per_class=1)
    extra = ("--imagenet-val", str(val))
    assert jax_main.main(_eval_argv(tmp_path / "jax", "e", flickr, pt, *extra)) == 0
    assert main_mod.main(["--device", "cpu", *_eval_argv(tmp_path / "port", "e", flickr, pt,
                                                         *extra)]) == 0
    want, got = _results(tmp_path / "jax", "e"), _results(tmp_path / "port", "e")
    assert len(got) == len(want) == 1 and got == want
    assert got[0]["epoch"] == 0 and "flickr_text_to_image_R@1" in got[0]
    assert "imagenet-zeroshot-val-top1" in got[0]
    # no checkpoint is written and no step is taken
    assert os.listdir(tmp_path / "port" / "e" / "checkpoints") == ["results.jsonl"]


def test_main_eval_only_refuses_when_no_suite_builds(tmp_path, models):
    _, params, _ = models
    pt = save_pt_checkpoint(str(tmp_path / "w.pt"), params)
    missing = str(tmp_path / "nowhere" / "flickr30k-images")
    assert main_mod.main(["--device", "cpu", *_eval_argv(tmp_path, "none", missing, pt)]) == 1
    with open(tmp_path / "none" / "out.log") as f:
        log = f.read()
    assert "skipping retrieval suite flickr" in log
    assert "eval-only mode but no retrieval suites configured" in log


def test_main_epoch_end_eval_after_synthetic_training(tmp_path, flickr):
    """--val-frequency 1: one results.jsonl line an epoch, after the epoch's
    steps; --zeroshot-frequency 2 adds zero-shot at epoch 2 only."""
    val = tmp_path / "val"
    _write_imagenet(str(val), n_classes=4, per_class=1)
    argv = ["--device", "cpu", "--model", TINY, "--dataset-type", "synthetic",
            "--train-num-samples", "16", "--batch-size", "8", "--epochs", "2", "--lr", "1e-3",
            "--warmup", "1", "--precision", "fp32", "--logs", str(tmp_path), "--name", "t",
            "--workers", "0", "--save-frequency", "1", "--seed", "0",
            "--retrieval-flickr", "--flickr-data-root-dir", flickr, "--val-frequency", "1",
            "--imagenet-val", str(val), "--zeroshot-frequency", "2",
            "--eval-scoring", "maxsim", "--token-mask-mode", "valid"]
    assert main_mod.main(argv) == 0
    lines = _results(tmp_path, "t")
    assert [r["epoch"] for r in lines] == [1, 2]
    assert "imagenet-zeroshot-val-top1" not in lines[0]
    assert "imagenet-zeroshot-val-top1" in lines[1]
    for r in lines:
        assert 0.0 <= r["flickr_text_to_image_R@1"] <= 1.0 and r["flickr_num_image_samples"] == 7
    assert os.path.isdir(tmp_path / "t" / "checkpoints" / "epoch_2")
    with open(tmp_path / "t" / "out.log") as f:
        log = f.read()
    assert log.index("Epoch 0 done") < log.index("eval epoch 1") < log.index("Epoch 1 done")
    assert "flickr seconds: image load + transform" in log
    shutil.rmtree(tmp_path / "t")
