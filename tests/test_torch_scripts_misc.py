"""The rest of the port's command-line twins against their JAX twins, on the
CPU: ``examples/torch_minimal_example.py``,
``scripts/torch_caption_length_stats.py``, ``scripts/torch_pack_shards.py``,
``scripts/torch_check_parity.py``, ``scripts/torch_verify_drive.py``,
``scripts/torch_int8_drift.py`` and the three launchers
(``scripts/torch_inference.sh``, ``torch_test_smoke.sh``,
``torch_train_colxlip_cc3m.sh``, run through ``bash`` at a tiny config with
``--device cpu``).

Each Python twin runs in this process beside its JAX twin, on the same
weights where there are weights: a seeded JAX init of
``ViT-S-16-test-colxlip`` exported once with ``export_pt_state_dict`` to a
``.pt``. The JAX scripts that cannot be run as they stand are reproduced
through the JAX package's public API, step by step as they run it: the
minimal example hard-codes ``ViT-B-32-colxlip`` and a 224-pixel image, and
the verify drive runs at import, in bf16, for 150 steps. The JAX int8 drift
runs as it is, with its model held to fp32 (the port's twin takes
``--precision fp32``), its initial weights and unrounded losses read on the
way. Both sides use exact-erf GELU.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import colxlip_tpu.models as jax_models
import colxlip_tpu.parallel.train_step as jax_train_step
from colxlip_tpu.data.pack import main as jax_pack_main
from colxlip_tpu.factory import create_model_and_transforms as jax_create_model_and_transforms
from colxlip_tpu.factory import get_tokenizer as jax_get_tokenizer
from colxlip_tpu.losses.colclip import colclip_loss as jax_colclip_loss
from colxlip_tpu.training.checkpoint import save_pt_checkpoint as jax_save_pt
from colxlip_tpu_torch.data.shard_writer import write_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "ViT-S-16-test-colxlip"
DRIVE = "ViT-S-16-test"           # the drives' config (a ColXLIP model on it)
PROB_TOL = 1e-5
LOSS_TOL = 1e-5


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def stdout_of(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


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
    mp = pytest.MonkeyPatch()
    mp.setenv("COLXLIP_GELU_IMPL", "stock")
    mp.setenv("JAX_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The seeded JAX init of the tiny ColXLIP as a .pt."""
    from colxlip_tpu.factory import create_model

    model, cfg = create_model(TINY, precision="fp32")
    params = jax.tree.map(np.asarray, init_params_jit(model, cfg, 3))
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.pt")
    jax_save_pt(path, params, name=TINY)
    return path


def test_minimal_example_equals_jax(tiny, monkeypatch):
    """The example's two rows of probabilities at the tiny config on the same
    .pt, in fp32: within 1e-5 of the JAX example's computation (its
    ``create_model_and_transforms``, ``get_logits``, ``get_logits_as_clip``
    and softmax on the same seeded image and captions), each row summing to
    one."""
    example = load("examples/torch_minimal_example.py", "torch_minimal_example")
    late, clip = example.run(TINY, tiny, "cpu")
    model, cfg, params, _, _ = jax_create_model_and_transforms(TINY, pretrained=tiny,
                                                               precision="fp32")
    size = cfg.vision_cfg.image_size
    image = jnp.asarray(np.random.default_rng(0).standard_normal((1, size, size, 3))
                        .astype(np.float32))
    texts = jnp.asarray(jax_get_tokenizer(TINY)(example.CAPTIONS))
    logits, _ = model.apply(params, image, texts, method=lambda m, i, t: m.get_logits(i, t))
    clip_logits, _ = model.apply(params, image, texts,
                                 method=lambda m, i, t: m.get_logits_as_clip(i, t))
    for got, want in ((late, logits), (clip, clip_logits)):
        want = np.asarray(jax.nn.softmax(want, axis=-1))
        assert got.shape == want.shape == (1, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
        assert abs(got.sum() - 1) <= 1e-5
    monkeypatch.setattr(example, "MODEL", TINY)        # main's model (ViT-B-32-colxlip)
    rc, printed = stdout_of(example.main, [tiny, "--device", "cpu"])
    assert rc == 0 and "late-interaction probs:" in printed and "plain-CLIP probs:" in printed


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two seeded tar shards of four samples (JPEGs and the recaption JSON)."""
    root = str(tmp_path_factory.mktemp("shards"))
    write_shards(root, 2, 4, short_side=64, long_side=(64, 96), workers=1)
    return os.path.join(root, "{0000..0001}.tar")


def test_caption_length_stats_report_equals_jax(shards, monkeypatch):
    """The report on the vendored annotations, the merged sampler and one
    seeded shard spec: line for line the JAX script's."""
    argv = ["--train-data", shards, "--num-samples", "40", "--buckets", "16", "32"]
    jax_script = load("scripts/caption_length_stats.py", "caption_length_stats")
    monkeypatch.setattr(sys, "argv", ["caption_length_stats.py", *argv])
    _, want = stdout_of(jax_script.main)
    rc, got = stdout_of(load("scripts/torch_caption_length_stats.py",
                             "torch_caption_length_stats").main, argv)
    assert rc == 0 and got == want
    sources = [json.loads(line)["source"] for line in got.splitlines()]
    assert any(s.startswith("coco_val2017") for s in sources)
    assert any(s.startswith("train_feed") for s in sources)


def test_pack_shards_equal_jax(shards, tmp_path):
    """Two seeded shards packed by each: every output file byte-equal."""
    argv = ["--urls", shards, "--size", "48", "--workers", "1"]
    assert jax_pack_main([*argv, "--out-dir", str(tmp_path / "jax")]) == 0
    twin = load("scripts/torch_pack_shards.py", "torch_pack_shards")
    assert twin.main([*argv, "--out-dir", str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and "sizes.json" in names
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


EXPECTED = {"checkpoint": "seeded", "tolerance": 0.01,
            "metrics": {"flickr_text_to_image_R@1": 0.5, "flickr_image_to_text_R@5": 0.9}}


@pytest.mark.parametrize("case,rc", [("pass", 0), ("miss", 1), ("missing-key", 1),
                                     ("unrecorded", 2), ("needs-bpe", None)])
def test_check_parity_gives_the_jax_verdict(tmp_path, monkeypatch, capsys, case, rc):
    """The same exit code and the same printed verdict as the JAX script on
    a seeded results.jsonl (two lines; the last is checked) and expected
    JSON, within tolerance, outside it, with a metric missing, with the
    goldens unrecorded, and with goldens that need the BPE asset."""
    expected = json.loads(json.dumps(EXPECTED))
    got_line = {"flickr_text_to_image_R@1": 0.505, "flickr_image_to_text_R@5": 0.895}
    if case == "miss":
        got_line["flickr_text_to_image_R@1"] = 0.45
    elif case == "missing-key":
        del got_line["flickr_image_to_text_R@5"]
    elif case == "unrecorded":
        expected["metrics"] = None
    elif case == "needs-bpe":
        expected["requires_clip_bpe"] = True
    results, exp = tmp_path / "results.jsonl", tmp_path / "expected.json"
    results.write_text(json.dumps({"flickr_text_to_image_R@1": 0.0}) + "\n"
                       + json.dumps(got_line) + "\n")
    exp.write_text(json.dumps(expected))
    argv = [str(results), str(exp)]
    jax_script = load("scripts/check_parity.py", "check_parity")
    monkeypatch.setattr(sys, "argv", ["check_parity.py", *argv])
    want_rc = jax_script.main()
    want = capsys.readouterr()
    got_rc = load("scripts/torch_check_parity.py", "torch_check_parity").main(argv)
    got = capsys.readouterr()
    assert got_rc == want_rc and got.out == want.out
    assert ("ERROR" in got.err) == ("ERROR" in want.err)
    if rc is not None:
        assert got_rc == rc


def test_verify_drive_first_loss_equals_jax(tmp_path):
    """Three steps of the drive on the CPU in fp32 from the JAX drive's own
    initial weights: the attention check passes (the plain versions on both
    sides), the losses are finite, and the first equals the JAX drive's
    step-0 loss within 1e-5 (its pairs and init, reproduced through the JAX
    API in fp32)."""
    rng = np.random.default_rng(0)
    rng.standard_normal((8, 197, 3 * 768))            # the drive's attention check draws first
    cfg = jax_models.CLIPCfg.from_dict(jax_models.get_model_config(DRIVE))
    model = jax_models.ColXLIP(cfg, dtype=jnp.float32)
    n, size = 16, cfg.vision_cfg.image_size
    images_np = rng.standard_normal((n, size, size, 3)) * 0.2
    images_np += np.arange(n)[:, None, None, None] * 0.15
    images = jnp.asarray(images_np.astype(np.float32))
    texts_np = np.zeros((n, cfg.text_cfg.context_length), np.int32)
    texts_np[:, 0] = 49406
    for i in range(n):
        texts_np[i, 1:6] = 100 + 7 * i + np.arange(5)
        texts_np[i, 6] = 49407
    params = jax.jit(model.init)(jax.random.PRNGKey(0), images[:2], jnp.asarray(texts_np)[:2])

    @jax.jit
    def loss(p):
        out = model.apply(p, images, jnp.asarray(texts_np))
        return jax_colclip_loss(out["image_features"], out["text_features"],
                                out["token_image_features"], out["token_text_features"],
                                out["logit_scale"])["total_loss"]

    want = float(loss(params))
    pt = str(tmp_path / "drive.pt")
    jax_save_pt(pt, jax.tree.map(np.asarray, params))

    drive = load("scripts/torch_verify_drive.py", "torch_verify_drive")
    rng = np.random.default_rng(0)
    assert drive.check_attention(torch.device("cpu"), rng) == (0.0, 0.0)
    got = drive.train_drive(torch.device("cpu"), rng, steps=3, precision="fp32", checkpoint=pt)
    losses = [v for _, v in got["losses"]]
    assert [i for i, _ in got["losses"]] == [0, 2] and np.isfinite(losses).all()
    assert abs(losses[0] - want) <= LOSS_TOL * max(1.0, abs(want))
    assert 0 <= got["r1_global"] <= 1 and 0 <= got["r1_maxsim"] <= 1


def test_int8_drift_first_loss_equals_jax(tmp_path, monkeypatch, capsys):
    """Three steps at batch 8 on the CPU, both scripts as they run, the JAX
    model held to fp32 and the twin at --precision fp32 from the JAX
    script's initial weights: finite losses, the first equal to the JAX
    script's within 1e-5, and the JSON line of the same shape."""
    argv = ["--model", DRIVE, "--batch-size", "8", "--steps", "3", "--log-every", "1",
            "--pool-batches", "2", "--image-size", "64"]
    real_colxlip, real_init = jax_models.ColXLIP, jax_train_step.init_train_state
    real_step = jax_train_step.make_train_step
    seen = {"losses": []}
    monkeypatch.setattr(jax_models, "ColXLIP",
                        lambda cfg, dtype=None: real_colxlip(cfg, dtype=jnp.float32))

    def init(*args):
        state = real_init(*args)
        seen["params"] = jax.tree.map(np.asarray, state.params)   # the step donates them
        return state

    def make_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def recorded(state, images, texts):
            state, metrics = step(state, images, texts)
            seen["losses"].append(float(metrics["total_loss"]))
            return state, metrics
        return recorded

    monkeypatch.setattr(jax_train_step, "init_train_state", init)
    monkeypatch.setattr(jax_train_step, "make_train_step", make_step)
    monkeypatch.setattr(sys, "argv", ["int8_drift.py", *argv])
    jax_script = load("scripts/int8_drift.py", "int8_drift")
    jax_script.main()
    want = json.loads(capsys.readouterr().out)
    pt = str(tmp_path / "drift.pt")
    jax_save_pt(pt, seen["params"])

    twin = load("scripts/torch_int8_drift.py", "torch_int8_drift")
    port_argv = [*argv, "--precision", "fp32", "--checkpoint", pt, "--device", "cpu"]
    got = twin.drift(twin.parse_args(port_argv))
    losses = [v for _, v in got["trajectory"]]
    assert [i for i, _ in got["trajectory"]] == [0, 1, 2] and np.isfinite(losses).all()
    assert len(seen["losses"]) == 3
    assert abs(losses[0] - seen["losses"][0]) <= LOSS_TOL * max(1.0, abs(seen["losses"][0]))
    rc, printed = stdout_of(twin.main, port_argv)
    line = json.loads(printed)
    assert rc == 0 and set(line) == set(want) and set(line["config"]) == set(want["config"])
    assert [i for i, _ in line["trajectory"]] == [i for i, _ in want["trajectory"]]


def _bash(script, env_extra, *args, cwd):
    env = {**os.environ, **env_extra,
           "PATH": os.path.dirname(sys.executable) + os.pathsep + os.environ.get("PATH", ""),
           "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.Popen(["bash", os.path.join(REPO, "scripts", script), *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:           # a hung run: stop bash and the python under it
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _flickr_subset(root, n=4):
    """DATAROOT with the vendored Flickr30k annotations' first ``n`` images
    and seeded JPEGs at their paths (no other suite: each is skipped)."""
    with open(os.path.join(REPO, "datasets", "flickr30k-images", "flickr30k_val.json")) as f:
        anns = json.load(f)[:n]
    img_dir = os.path.join(root, "flickr30k-images")
    os.makedirs(img_dir)
    rng = np.random.default_rng(4)
    for ann in anns:
        arr = (rng.random((72, 96, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, ann["image"]), quality=90)
    with open(os.path.join(img_dir, "flickr30k_val.json"), "w") as f:
        json.dump(anns, f)
    return root


@pytest.mark.parametrize("launcher", ["torch_inference.sh", "torch_test_smoke.sh",
                                      "torch_train_colxlip_cc3m.sh"])
def test_launchers_run_on_the_cpu(launcher, tiny, shards, tmp_path):
    """Each launcher through bash at the tiny config with --device cpu
    passed through "$@": rc 0 and the run's own outputs (the eval's
    results.jsonl with the Flickr metrics; the trainers' checkpoints)."""
    logs = str(tmp_path / "logs")
    common = ["--model", TINY, "--device", "cpu", "--logs", logs]
    if launcher == "torch_inference.sh":
        env = {"CKPT": tiny, "DATAROOT": _flickr_subset(str(tmp_path / "data"))}
        args = [*common, "--name", "inf", "--batch-size", "4", "--precision", "fp32",
                "--allow-degraded-tokenizer"]
    elif launcher == "torch_test_smoke.sh":
        env, args = {}, [*common, "--train-num-samples", "16", "--batch-size", "8"]
    else:
        env = {"DATA": shards, "COCO_DIR": str(tmp_path / "no-coco")}
        args = [*common, "--name", "cc3m", "--train-num-samples", "8", "--batch-size", "4",
                "--epochs", "1", "--workers", "1", "--warmup", "1"]
    done = _bash(launcher, env, *args, cwd=str(tmp_path))
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-4000:]
    if launcher == "torch_inference.sh":
        with open(os.path.join(logs, "inf", "checkpoints", "results.jsonl")) as f:
            results = [json.loads(line) for line in f]
        assert len(results) == 1 and results[0]["flickr_num_image_samples"] == 4
        assert "flickr_text_to_image_R@1" in results[0]
    else:
        name = "smoke" if launcher == "torch_test_smoke.sh" else "cc3m"
        assert "epoch_1" in os.listdir(os.path.join(logs, name, "checkpoints"))


def test_every_launcher_and_twin_has_its_jax_twin():
    """Each port script sits beside the JAX script it mirrors."""
    pairs = {"torch_build_index.py": "build_index.py", "torch_export_pt.py": "export_pt.py",
             "torch_generate_captions.py": "generate_captions.py",
             "torch_check_parity.py": "check_parity.py",
             "torch_caption_length_stats.py": "caption_length_stats.py",
             "torch_pack_shards.py": "pack_shards.py", "torch_verify_drive.py": "verify_drive.py",
             "torch_int8_drift.py": "int8_drift.py", "torch_inference.sh": "inference.sh",
             "torch_test_smoke.sh": "test_smoke.sh",
             "torch_train_colxlip_cc3m.sh": "train_colxlip_cc3m_v5e.sh"}
    for twin, original in pairs.items():
        assert os.path.isfile(os.path.join(REPO, "scripts", twin)), twin
        assert os.path.isfile(os.path.join(REPO, "scripts", original)), original
    assert os.path.isfile(os.path.join(REPO, "examples", "torch_minimal_example.py"))
    for launcher in ("torch_inference.sh", "torch_test_smoke.sh", "torch_train_colxlip_cc3m.sh"):
        with open(os.path.join(REPO, "scripts", launcher)) as f:
            text = f.read()
        assert "python -m colxlip_tpu_torch.main" in text and '"$@"' in text
        assert "colxlip_tpu.main" not in text.replace("colxlip_tpu_torch.main", "")
