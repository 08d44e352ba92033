"""The port's command-line twins of the JAX scripts, against those scripts, on
the CPU: ``scripts/torch_build_index.py`` (build, search),
``scripts/torch_export_pt.py`` (a whole and a sharded checkpoint of the port)
and ``scripts/torch_generate_captions.py``.

Both scripts of a pair run in this process (loaded through ``importlib`` as
``tests/test_torch_aot.py`` loads ``torch_export_aot.py``) on the same
weights: a seeded JAX init of ``ViT-S-16-test-colxlip`` exported once with
``export_pt_state_dict`` to a ``.pt`` that both load, and, for captioning, a
seeded JAX init of ``coca-S-test`` (the JAX script's own random init, which
it takes without ``--checkpoint``; the port loads it converted to a ``.pt``,
as the JAX exporter refuses CoCa trees). The JAX scripts build their models
in bf16; here their ``create_model`` is held to fp32, and the port's twin
takes ``--precision fp32``, so the two sides meet at fp32 bars. Both sides
use exact-erf GELU (``COLXLIP_GELU_IMPL=stock``). The JAX scripts write
their compile cache to ``$JAX_CACHE_DIR``, pointed into a temporary
directory.
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import io
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import colxlip_tpu.factory as jax_factory
import colxlip_tpu.serving.generate as jax_generate
import colxlip_tpu.serving.index as jax_index
from colxlip_tpu.training.checkpoint import save_pt_checkpoint as jax_save_pt
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.serving import generate as port_generate
from colxlip_tpu_torch.serving import index as port_index
from colxlip_tpu_torch.serving.index import RetrievalIndex
from colxlip_tpu_torch.training import checkpoint as port_ckpt
from colxlip_tpu_torch.training.evaluate import score_similarity
from colxlip_tpu_torch.training.optim import create_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "ViT-S-16-test-colxlip"
COCA = "coca-S-test"
POOLED_TOL = 1e-5
SCORE_TOL = 2e-3          # scores as the scripts print them: three decimals
QUERIES = ["a red car on a street", "two dogs play in the snow"]


def load_script(name: str):
    """A script of ``scripts/`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        name.replace("/", "_"), os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(script, argv, monkeypatch) -> str:
    """A JAX script's ``main()`` (it reads ``sys.argv``); its stdout."""
    monkeypatch.setattr(sys, "argv", [script.__name__, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        script.main()
    return out.getvalue()


def run_port(script, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert script.main(argv) == 0
    return out.getvalue()


def init_params_jit(model, cfg, seed):
    """``colxlip_tpu.factory.init_params`` under ``jax.jit`` (the same
    values, without an eager walk of every initializer)."""
    size = cfg.vision_cfg.image_size
    images = jnp.zeros((1, size, size, 3), jnp.float32)
    texts = jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32).at[:, 0].set(49406)
    return jax.jit(model.init)(jax.random.PRNGKey(seed), images, texts.at[:, 1].set(49407))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small tensor operations: one intra-op thread, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    """Exact erf on both sides; the JAX scripts' models in fp32 and their
    compile cache under a temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setenv("COLXLIP_GELU_IMPL", "stock")
    mp.setenv("JAX_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    mp.setattr(jax_factory, "create_model",
               functools.partial(jax_factory.create_model, precision="fp32"))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(the seeded JAX init of the tiny ColXLIP as a .pt, its JAX params)."""
    model, cfg = jax_factory.create_model(TINY)
    params = jax.tree.map(np.asarray, init_params_jit(model, cfg, 3))
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.pt")
    jax_save_pt(path, params, name=TINY)
    return path, params


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Six seeded JPEGs of varied sizes under nested folders, and one file
    that is no image (both scripts skip it)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for i in range(6):
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        h, w = (int(x) for x in rng.integers(48, 120, 2))
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(sub / f"img{i}.jpg", quality=90)
    (root / "broken.png").write_bytes(b"not an image")
    return str(root)


@pytest.fixture(scope="module")
def indexes(tiny, images, tmp_path_factory):
    """The index of the corpus written by each build script, and the fp32
    pooled rows each handed its index writer (the files hold fp16)."""
    pt, _ = tiny
    out = tmp_path_factory.mktemp("indexes")
    handed = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    for module, key in ((jax_index, "jax"), (port_index, "port")):
        real = module.IndexWriter.add
        mp.setattr(module.IndexWriter, "add",
                   lambda self, p, t, *a, _real=real, _key=key, **k: (
                       handed[_key].append((np.array(p, np.float32), np.array(t, np.float32))),
                       _real(self, p, t, *a, **k))[1])
    port = load_script("torch_build_index")
    try:
        run_jax(load_script("build_index"), ["build", "--model", TINY, "--checkpoint", pt,
                                             "--images", images, "--out", str(out / "jax"),
                                             "--batch-size", "4"], mp)
        run_port(port, ["build", "--model", TINY, "--checkpoint", pt, "--images", images,
                        "--out", str(out / "port"), "--batch-size", "4", "--precision",
                        "fp32", "--device", "cpu"])
    finally:
        mp.undo()
    return str(out / "jax"), str(out / "port"), port, {
        k: [np.concatenate(x) for x in zip(*v)] for k, v in handed.items()}


def test_build_index_equals_the_jax_scripts(indexes):
    """Six seeded JPEGs (one unreadable file skipped): the same ids in the
    same order, the pooled and token rows within 1e-5 as encoded (fp32), the
    files' fp16 rows within fp16's rounding of them (2^-10 relative; a few
    subnormal steps near zero), the same meta."""
    jax_dir, port_dir, _, handed = indexes
    for got, want, shape in zip(handed["port"], handed["jax"], ((6, 128), (6, 16, 128))):
        assert got.shape == want.shape == shape
        np.testing.assert_allclose(got, want, rtol=0, atol=POOLED_TOL)
    want, got = RetrievalIndex(jax_dir, device="cpu"), RetrievalIndex(port_dir, device="cpu")
    assert got.ids == want.ids and len(got) == 6
    assert got.ids == sorted(got.ids) and all(i.endswith(".jpg") for i in got.ids)
    assert {k: v for k, v in got.meta.items() if k != "logit_scale"} == \
        {k: v for k, v in want.meta.items() if k != "logit_scale"}
    assert got.logit_scale == pytest.approx(want.logit_scale, rel=1e-6)
    np.testing.assert_allclose(np.asarray(got.pooled, np.float32),
                               np.asarray(want.pooled, np.float32), rtol=2.0 ** -10,
                               atol=2.0 ** -22)
    tg, tw = np.asarray(got.tokens, np.float32), np.asarray(want.tokens, np.float32)
    assert got.tokens.dtype == np.float16 and tg.shape == tw.shape
    np.testing.assert_allclose(tg, tw, rtol=2.0 ** -10, atol=2.0 ** -22)


@pytest.mark.parametrize("scoring", ["maxsim", "mixed", "global"])
def test_search_equals_the_jax_scripts(indexes, tiny, monkeypatch, scoring):
    """Two queries over the JAX script's index at shortlist 4: the same
    top-k items in order, the printed scores within 2e-3; the port's items and scores
    are the ``score_similarity`` recomputation's over its own index."""
    jax_dir, port_dir, port, _ = indexes
    pt, _ = tiny
    jax_script = load_script("build_index")
    for query in QUERIES:
        argv = ["search", "--model", TINY, "--checkpoint", pt, "--index", jax_dir, "--query",
                query, "-k", "3", "--shortlist", "4", "--scoring", scoring]
        want = _ranked(run_jax(jax_script, argv, monkeypatch))
        got = _ranked(run_port(port, [*argv, "--precision", "fp32", "--device", "cpu"]))
        assert [name for name, _ in got] == [name for name, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0,
                                   atol=SCORE_TOL)
    # several queries in one call, over the port's own index, against a
    # recomputation of every score through the eval's scoring
    text = run_port(port, ["search", "--model", TINY, "--checkpoint", pt, "--index", port_dir,
                           "--query", *QUERIES, "-k", "6", "--shortlist", "6", "--scoring",
                           scoring, "--precision", "fp32", "--device", "cpu"])
    blocks = text.split("query: ")[1:]
    assert [b.splitlines()[0] for b in blocks] == QUERIES
    model, cfg = factory.create_model(TINY, "cpu", torch.float32)
    factory.load_weights(model, pt)
    idx = RetrievalIndex(port_dir, device="cpu")
    from colxlip_tpu_torch.data.tokenizer import get_tokenizer_cached

    toks = torch.from_numpy(get_tokenizer_cached(cfg.text_cfg.context_length)(QUERIES)).long()
    with torch.no_grad():
        q_pooled, q_tokens = model.encode_text(toks, normalize=True)
    sim = score_similarity(
        torch.from_numpy(np.asarray(idx.pooled, np.float32)), q_pooled.float(),
        torch.from_numpy(np.asarray(idx.tokens, np.float32)), q_tokens.float(),
        logit_scale=idx.logit_scale, scoring=scoring, alpha=0.5).T.numpy()
    for row, block in zip(sim, blocks):
        ranked = _ranked(block.split("\n", 1)[1])
        want = np.sort(row)[::-1]
        np.testing.assert_allclose([s for _, s in ranked], want, rtol=0, atol=SCORE_TOL)
        for name, s in ranked:
            assert abs(row[idx.ids.index(name)] - s) <= SCORE_TOL


def _ranked(text: str):
    """[(id, score)] of a search's ``rank  score  id`` lines."""
    out = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0].isdigit():
            out.append((parts[2], float(parts[1])))
    return out


def _port_model(pt):
    model, _ = factory.create_model(TINY, "cpu", torch.float32)
    factory.load_weights(model, pt)
    return model


@pytest.fixture(scope="module")
def port_checkpoints(tiny, tmp_path_factory):
    """The tiny weights as a whole checkpoint directory of the port and as a
    sharded one (``save_checkpoint_sharded`` under a gloo group of one, a
    mesh of one), each with an AdamW state beside the weights."""
    import torch.distributed as dist

    pt, _ = tiny
    root = tmp_path_factory.mktemp("ckpts")
    model = _port_model(pt)
    opt = create_optimizer(model, 1e-4)
    whole = port_ckpt.save_checkpoint(str(root / "whole"),
                                      port_ckpt.train_state(model, opt, 7), epoch=1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        sharded = port_ckpt.save_checkpoint_sharded(
            str(root / "sharded"), port_ckpt.sharded_train_state(model, opt, 7), epoch=1)
    finally:
        dist.destroy_process_group()
    assert port_ckpt.is_sharded_checkpoint(sharded)
    assert not port_ckpt.is_sharded_checkpoint(whole)
    return {"whole": whole, "sharded": sharded}


@pytest.mark.parametrize("kind", ["whole", "sharded"])
def test_export_pt_equals_the_jax_scripts(tiny, port_checkpoints, tmp_path, monkeypatch, kind):
    """A checkpoint of the port, whole or sharded, exported by the twin: the
    same keys and tensors as the JAX script's export of the same weights
    (read from the .pt; the logit scale 0-dim as the reference's), and the
    JAX ``load_weights`` reads it back equal to the weights it came from."""
    pt, params = tiny
    want_path, got_path = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    run_jax(load_script("export_pt"), ["--model", TINY, "--checkpoint", pt, "--out", want_path,
                                       "--name", "x"], monkeypatch)
    printed = run_port(load_script("torch_export_pt"),
                       ["--model", TINY, "--checkpoint", port_checkpoints[kind], "--out",
                        got_path, "--name", "x", "--device", "cpu"])
    assert f'"out": "{got_path}"' in printed
    want = torch.load(want_path, weights_only=False)
    got = torch.load(got_path, weights_only=True)
    assert (got["epoch"], got["name"]) == (want["epoch"], want["name"]) == (0, "x")
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for key, value in got["state_dict"].items():
        ref = torch.as_tensor(want["state_dict"][key])
        assert value.dtype == torch.float32
        # the port writes the logit scale as the reference's 0-dim parameter,
        # the JAX exporter as a [1] vector; the JAX loader reads either
        assert value.shape == ref.shape or (key == "logit_scale" and value.numel() == 1), key
        assert torch.equal(value.flatten(), ref.flatten()), key
    model, cfg = jax_factory.create_model(TINY)
    back = jax_factory.load_weights(model, cfg, got_path, model_name=TINY)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path], err_msg=str(path))


@pytest.fixture(scope="module")
def coca(tmp_path_factory):
    """The JAX captioning script's own weights (``init_params`` at --seed 0)
    as a .pt of the port's layout."""
    model, cfg = jax_factory.create_model(COCA)
    params = jax.tree.map(np.asarray, init_params_jit(model, cfg, 0))
    sd = convert.state_dict_from_jax_params(params)
    path = str(tmp_path_factory.mktemp("coca") / "coca.pt")
    port_ckpt.save_pt_checkpoint(path, {k: torch.from_numpy(v) for k, v in sd.items()})
    return path


def test_generate_captions_equals_the_jax_scripts(coca, images, monkeypatch):
    """Greedy captions of three seeded JPEGs: the same tokens and the same
    printed lines as the JAX script on the same weights."""
    paths = [os.path.join(images, sub, f"img{i}.jpg") for sub, i in (("b", 0), ("a", 1),
                                                                      ("b", 2))]
    seen = {}

    def record(module, key):
        real = module.generate_captions

        def wrapped(*args, **kwargs):
            seen[key] = np.asarray(real(*args, **kwargs))
            return seen[key]
        monkeypatch.setattr(module, "generate_captions", wrapped)

    record(jax_generate, "jax")
    record(port_generate, "port")
    want = run_jax(load_script("generate_captions"), ["--model", COCA, "--images", *paths],
                   monkeypatch)
    got = run_port(load_script("torch_generate_captions"),
                   ["--model", COCA, "--checkpoint", coca, "--images", *paths,
                    "--precision", "fp32", "--device", "cpu"])
    assert seen["port"].shape == seen["jax"].shape == (3, 32)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert got == want and len(got.splitlines()) == 3


@pytest.mark.parametrize("script,argv", [
    ("scripts/torch_build_index.py", ["search", "--index", "x", "--query", "q"]),
    ("scripts/torch_export_pt.py", ["--model", TINY, "--checkpoint", "x.pt", "--out", "y.pt"]),
    ("scripts/torch_generate_captions.py", ["--images", "x.jpg"]),
    ("scripts/torch_verify_drive.py", []),
    ("scripts/torch_int8_drift.py", []),
    ("examples/torch_minimal_example.py", []),
])
def test_twins_run_on_the_card_unless_told_cpu(script, argv, monkeypatch):
    """With no --device a twin takes cuda:0, and on a machine without a card
    it raises before it does any work (the CPU only when asked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(os.path.basename(script)[:-3],
                                                  os.path.join(REPO, script))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with pytest.raises(RuntimeError, match="--device cuda:0: no CUDA device is available"):
        module.main(argv)
