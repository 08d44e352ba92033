"""The port's training entry point and what it is built from, on the CPU,
against the JAX package: the synthetic stream, the flag surface, the
checkpoint directory rules, the remat knob, the prefetch and epoch loop,
``main`` itself (train, save, resume, preemption, refusals), and the train
state carried across from JAX (weights through a ``.pt``, the AdamW moments
through ``convert.load_optax_adamw_state``).

Tiny ``ViT-S-16-test`` in fp32. Tolerances: the synthetic stream, the flag
defaults and a resumed run's losses are exact; losses logged by the two
packages' ``train_one_epoch`` from one ``.pt`` agree to 1e-4 relative (fp32
sums in another order through three AdamW steps); parameters after a step
from a carried-over AdamW state agree to 1e-5 (each side computes that
step's gradients itself, and Adam divides by sqrt(v) + 1e-6, so gradients
that are rounding noise, like the key biases', move by a few 1e-6).
"""
from __future__ import annotations

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu import params as jax_params
from colxlip_tpu.data import synthetic as jax_synthetic
from colxlip_tpu.factory import create_model_and_transforms as jax_create_model_and_transforms
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.training import checkpoint as jax_checkpoint
from colxlip_tpu.training import optim as jax_optim
from colxlip_tpu.training import schedules as jax_schedules
from colxlip_tpu.training import train as jax_train
from colxlip_tpu_torch import convert, factory, params
from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch.data import synthetic
from colxlip_tpu_torch.data.tokenizer import EOT_TOKEN
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.training import checkpoint, optim, schedules
from colxlip_tpu_torch.training.logging_utils import AverageMeter, MetricsWriter
from colxlip_tpu_torch.training.train import _PrefetchIterator, select_caption0, train_one_epoch

TINY = "ViT-S-16-test"


# ---------------------------------------------------------------------------
# data, flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rank,world_size", [(0, 0, 1), (7, 0, 1), (3, 1, 2)])
def test_synthetic_stream_is_bit_equal_to_jax(seed, rank, world_size):
    kw = dict(batch_size=3, image_size=(16, 16), context_length=12, num_sampled_captions=2,
              seed=seed, num_samples=18, rank=rank, world_size=world_size)
    want = jax_synthetic.SyntheticDataset(jax_synthetic.SyntheticConfig(**kw))
    got = synthetic.SyntheticDataset(synthetic.SyntheticConfig(**kw))
    assert len(got) == len(want) == 18 // (3 * world_size)
    batches = 0
    for (gi, gt), (wi, wt) in zip(got, want):
        assert gi.dtype == wi.dtype and gt.dtype == wt.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
        batches += 1
    assert batches == len(want)
    with pytest.raises(ValueError, match="rank"):
        synthetic.SyntheticDataset(synthetic.SyntheticConfig(rank=2, world_size=2))


@pytest.mark.parametrize("argv", [[], ["--model", "RN50"],
                                  ["--aug-cfg", "scale=(0.4, 1.0)", "color_jitter=0.4"]])
def test_parse_args_defaults_equal_jax(argv):
    want, got = vars(jax_params.parse_args(argv)), vars(params.parse_args(argv))
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    for name, value in want.items():
        assert got[name] == value, name
    assert got["device"] == "cuda:0"


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_get_latest_checkpoint_resolution(tmp_path):
    """The directory cases of the JAX package's test: natural sort, a stale
    epoch_latest loses, a current one wins, .tmp / .old are ignored."""
    d = tmp_path / "ckpts"
    d.mkdir()
    for get in (checkpoint.get_latest_checkpoint, jax_checkpoint.get_latest_checkpoint):
        assert get(str(d)) is None
    assert checkpoint.get_latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("epoch_1", "epoch_2", "epoch_10"):
        (d / name).mkdir()
    assert checkpoint.get_latest_checkpoint(str(d)).endswith("epoch_10")
    latest = d / "epoch_latest"
    latest.mkdir()
    old = time.time() - 3600
    os.utime(latest, (old, old))
    assert checkpoint.get_latest_checkpoint(str(d)).endswith("epoch_10")
    now = time.time() + 60
    os.utime(latest, (now, now))
    assert checkpoint.get_latest_checkpoint(str(d)).endswith("epoch_latest")
    (d / "epoch_latest.tmp").mkdir()
    (d / "epoch_latest.old").mkdir()
    assert checkpoint.get_latest_checkpoint(str(d)).endswith("epoch_latest")
    assert checkpoint.get_latest_checkpoint(str(d)) == jax_checkpoint.get_latest_checkpoint(str(d))


def test_get_latest_checkpoint_is_a_positive_name_match(tmp_path):
    d = tmp_path / "ckpts"
    d.mkdir()
    for name in ("epoch_1", "epoch_2.tmp", "epoch_3.orbax-checkpoint-tmp-1234567890",
                 "epoch_4suffix"):
        (d / name).mkdir()
    assert checkpoint.get_latest_checkpoint(str(d)).endswith("epoch_1")
    (d / "epoch_1").rmdir()
    (d / "epoch_latest").mkdir()
    assert checkpoint.get_latest_checkpoint(str(d)).endswith("epoch_latest")


def test_rotate_checkpoints_save_frequency_gt_1(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    for e in (2, 4, 6):
        (d / f"epoch_{e}").mkdir()
    (d / "epoch_latest").mkdir()
    checkpoint.rotate_checkpoints(str(d), 6)
    assert sorted(p.name for p in d.iterdir()) == ["epoch_6", "epoch_latest"]


def _tiny_model(seed=0, **kw):
    model, _ = factory.create_model(TINY, "cpu", torch.float32, seed=seed, **kw)
    return model.train()


def test_checkpoint_roundtrip_sidecar_and_atomic_latest(tmp_path):
    model = _tiny_model()
    opt = optim.create_optimizer(model, 1e-3)
    step = make_train_step(model, opt, None, TrainStepConfig(loss_type="clip"))
    imgs, txts = next(iter(synthetic.SyntheticDataset(synthetic.SyntheticConfig(
        batch_size=4, image_size=(64, 64), context_length=32))))
    step(torch.from_numpy(imgs), torch.from_numpy(txts[:, 0]))
    d = str(tmp_path / "ck")
    path = checkpoint.save_checkpoint(d, checkpoint.train_state(model, opt, step.step),
                                      epoch=3, name="run")
    assert path.endswith("epoch_3") and checkpoint.read_step_in_epoch(path) == 0
    for _ in range(2):   # the second save replaces the first atomically
        latest = checkpoint.save_checkpoint(
            d, checkpoint.train_state(model, opt, step.step), epoch=3, name="run",
            most_recent=True, step_in_epoch=5)
    assert sorted(os.listdir(d)) == ["epoch_3", "epoch_latest"]
    assert checkpoint.read_step_in_epoch(latest) == 5
    with open(os.path.join(latest, "preempt.json")) as f:
        assert json.load(f) == {"epoch": 3, "step_in_epoch": 5}

    payload = checkpoint.load_native_checkpoint(latest)
    assert (payload["epoch"], payload["name"]) == (3, "run")
    fresh = _tiny_model(seed=1)
    fresh_opt = optim.create_optimizer(fresh, 1e-3)
    assert checkpoint.restore_train_state(payload["state"], fresh, fresh_opt) == 1
    for (k, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), k
    got, want = fresh_opt.state_dict()["state"], opt.state_dict()["state"]
    assert got.keys() == want.keys()
    for i in want:
        assert torch.equal(got[i]["exp_avg_sq"], want[i]["exp_avg_sq"])
    with pytest.raises(FileNotFoundError, match="orbax"):
        checkpoint.load_native_checkpoint(str(tmp_path))


def test_save_pt_checkpoint_is_read_by_both_packages(tmp_path):
    model = _tiny_model(seed=2)
    path = checkpoint.save_pt_checkpoint(str(tmp_path / "m.pt"), model, epoch=4, name="x")
    other = _tiny_model(seed=3)
    factory.load_weights(other, path)
    for (k, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k
    sd = jax_checkpoint.load_pt_state_dict(path)
    assert set(sd) == set(model.state_dict())


# ---------------------------------------------------------------------------
# remat, prefetch, epoch loop
# ---------------------------------------------------------------------------

def test_grad_checkpointing_gives_the_same_loss_and_gradients():
    imgs, txts = next(iter(synthetic.SyntheticDataset(synthetic.SyntheticConfig(
        batch_size=4, image_size=(64, 64), context_length=32, seed=1))))
    imgs, txts = torch.from_numpy(imgs), torch.from_numpy(txts[:, 0])
    results = []
    for remat in (False, True):
        model = _tiny_model(seed=4, grad_checkpointing=remat)
        assert model.visual.transformer.grad_checkpointing is remat
        step = make_train_step(model, optim.create_optimizer(model, 0.0), None,
                               TrainStepConfig(loss_type="clip", ce_impl="fused"))
        loss = step(imgs, txts)["total_loss"]
        results.append((loss, {k: p.grad.clone() for k, p in model.named_parameters()}))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert torch.equal(loss_a, loss_b)
    for k, g in grads_a.items():
        torch.testing.assert_close(grads_b[k], g, rtol=0, atol=1e-6 * g.abs().max().item())


def _batches(n, dtype, ctx=16):
    for i in range(n):
        texts = np.zeros((4, 2, ctx), np.int32)
        texts[:, 0, 0] = i
        yield np.full((4, 8, 8, 3), i, dtype), texts


def test_prefetch_selects_caption0_and_keeps_uint8():
    assert select_caption0(np.zeros((4, 16))).shape == (4, 16)
    it = _PrefetchIterator(_batches(3, np.uint8), device="cpu")
    imgs, texts = next(it)
    assert isinstance(imgs, torch.Tensor) and imgs.dtype == torch.uint8
    assert texts.shape == (4, 16) and texts.dtype == torch.int32
    it.close()
    it = _PrefetchIterator(_batches(3, np.float64), device="cpu")
    assert next(it)[0].dtype == torch.float32
    it.close()


def test_prefetch_truncation_meter_counts_an_exact_fit():
    """EOT in the last slot counts as truncated, whether the caption was cut
    or fits the context exactly (the JAX loop's rule)."""
    def batches():
        texts = np.zeros((4, 16), np.int32)
        texts[:, 0] = 49406
        texts[0, -1] = EOT_TOKEN      # cut by the tokenizer
        texts[1, 1:15] = 5
        texts[1, -1] = EOT_TOKEN      # 14 tokens + SOT + EOT: an exact fit
        texts[2:, 5] = EOT_TOKEN      # EOT inside the window
        yield np.zeros((4, 8, 8, 3), np.float32), texts

    meter = AverageMeter()
    it = _PrefetchIterator(batches(), device="cpu", trunc_meter=meter)
    next(it)
    with pytest.raises(StopIteration):
        next(it)
    it.close()
    assert meter.count == 1 and meter.avg == pytest.approx(0.5)


def test_prefetch_propagates_exception():
    def bad():
        yield next(_batches(1, np.float32))
        raise RuntimeError("decode failed")

    it = _PrefetchIterator(bad(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    it.close()
    assert not it._host_thread.is_alive() and not it._ship_thread.is_alive()


class _FakeStep:
    def __init__(self, step=0, on_step=None):
        self.step, self.calls, self.on_step = step, [], on_step

    def __call__(self, images, texts):
        self.calls.append(int(images[0, 0, 0, 0]))
        if self.on_step:
            self.on_step(self)
        self.step += 1
        return {"total_loss": torch.tensor(1.0), "logit_scale": torch.tensor(14.0)}


class _Collect:
    def __init__(self):
        self.records = []

    def write(self, metrics, step):
        self.records.append((step, dict(metrics)))


def test_train_one_epoch_counts_cuts_and_logs_at_boundaries():
    step, writer = _FakeStep(5), _Collect()
    steps, stopped = train_one_epoch(
        step, _batches(10, np.float32), epoch=0, global_batch_size=4, steps_per_epoch=4,
        log_every_n_steps=2, writer=writer, lr_schedule=schedules.const_lr(1e-3, 0),
        device="cpu")
    assert (steps, stopped, step.step, step.calls) == (4, False, 9, [0, 1, 2, 3])
    # metrics are read at i = 0, 2 and at the last step only
    assert [s for s, _ in writer.records] == [6, 8, 9]
    assert set(writer.records[0][1]) >= {"total_loss", "logit_scale", "samples_per_second",
                                         "text_trunc_rate", "data_time", "batch_time", "lr",
                                         "epoch"}


def test_train_one_epoch_skip_steps():
    step = _FakeStep(3)
    steps, stopped = train_one_epoch(
        step, _batches(10, np.float32), epoch=0, global_batch_size=4, steps_per_epoch=8,
        log_every_n_steps=100, skip_steps=3, device="cpu")
    assert (steps, stopped, step.step, step.calls) == (5, False, 8, [3, 4, 5, 6, 7])


def test_train_one_epoch_stop_flag():
    flag = threading.Event()
    step = _FakeStep(0, on_step=lambda s: flag.set() if s.step == 2 else None)
    steps, stopped = train_one_epoch(
        step, _batches(50, np.float32), epoch=0, global_batch_size=4,
        log_every_n_steps=100, stop_flag=flag, stop_check_every=2, device="cpu")
    # set during step i = 2; checks run after i = 0, 2, 4: stops at i = 2
    assert (steps, stopped, step.step) == (3, True, 3)


def test_metrics_writer_jsonl_and_missing_sinks(tmp_path):
    writer = MetricsWriter(str(tmp_path), "jsonl,wandb")   # wandb is not installed
    writer.write({"total_loss": torch.tensor(2.5), "lr": 1e-3}, 7)
    writer.close()
    with open(tmp_path / "metrics.jsonl") as f:
        record = json.loads(f.readline())
    assert record["step"] == 7 and record["total_loss"] == 2.5 and record["lr"] == 1e-3


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _argv(logs, name, *extra, epochs=2):
    return ["--device", "cpu", "--model", TINY, "--dataset-type", "synthetic",
            "--train-num-samples", "32", "--batch-size", "8", "--epochs", str(epochs),
            "--lr", "1e-3", "--warmup", "2", "--precision", "fp32", "--logs", str(logs),
            "--name", name, "--workers", "0", "--log-every-n-steps", "1",
            "--save-frequency", "1", "--ce-impl", "fused", "--seed", "0", *extra]


def _losses(logs, name):
    with open(os.path.join(logs, name, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [r["step"] for r in records], [r["total_loss"] for r in records]


def test_main_trains_saves_and_resumes_latest(tmp_path):
    logs = str(tmp_path)
    assert main_mod.main(_argv(logs, "run", "--save-most-recent",
                               "--delete-previous-checkpoint")) == 0
    base = os.path.join(logs, "run")
    ckpts = os.path.join(base, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["epoch_2", "epoch_latest"]   # epoch_1 rotated
    for name in ("params.txt", "out.log", "metrics.jsonl"):
        assert os.path.exists(os.path.join(base, name)), name
    with open(os.path.join(base, "params.txt")) as f:
        assert "ce_impl: fused\n" in f.read()
    steps, losses = _losses(logs, "run")
    assert steps == list(range(1, 9)) and np.isfinite(losses).all()
    assert losses[0] == pytest.approx(np.log(8), rel=0.3)   # near ln(batch) at step 1

    assert main_mod.main(_argv(logs, "run", "--resume", "latest", epochs=3)) == 0
    assert os.path.isdir(os.path.join(ckpts, "epoch_3"))
    steps, losses = _losses(logs, "run")
    assert steps == list(range(1, 13)) and np.isfinite(losses).all()
    with open(os.path.join(base, "out.log")) as f:
        assert "=> resuming checkpoint" in f.read()


def test_main_cut_mid_epoch_and_resumed_logs_the_uncut_losses(tmp_path, monkeypatch):
    logs = str(tmp_path)
    assert main_mod.main(_argv(logs, "uncut")) == 0

    real = main_mod.train_one_epoch

    class SignalDuringStep:
        """The train step, with the preemption flag set during update 6 (the
        2nd step of epoch 1)."""

        def __init__(self, inner, flag):
            self.inner, self.flag = inner, flag

        @property
        def step(self):
            return self.inner.step

        def __call__(self, images, texts):
            if self.inner.step == 5:
                self.flag.set()
            return self.inner(images, texts)

    monkeypatch.setattr(main_mod, "train_one_epoch", lambda step_fn, data, **kw: real(
        SignalDuringStep(step_fn, kw["stop_flag"]), data, **kw))
    preempt = ("--preempt-save", "--preempt-check-every", "1")
    assert main_mod.main(_argv(logs, "cut", *preempt)) == 0
    monkeypatch.setattr(main_mod, "train_one_epoch", real)
    ckpts = os.path.join(logs, "cut", "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["epoch_1", "epoch_latest"]
    assert checkpoint.read_step_in_epoch(os.path.join(ckpts, "epoch_latest")) == 2
    assert _losses(logs, "cut")[0] == [1, 2, 3, 4, 5, 6]

    assert main_mod.main(_argv(logs, "cut", *preempt, "--resume", "latest")) == 0
    assert os.path.isdir(os.path.join(ckpts, "epoch_2"))
    assert _losses(logs, "cut") == _losses(logs, "uncut")    # exact on the CPU


REFUSED = [
    (["--remote-sync", "s3://b"], "--remote-sync"),
    (["--model-parallel", "2"], "--model-parallel"),
    (["--fsdp"], "--fsdp"),
    (["--packed-feed"], "--packed-feed"),
    (["--pipeline", "grain"], "--pipeline grain"),
    (["--force-patch-dropout", "0.5"], "--force-patch-dropout"),
    (["--dataset-type", "auto"], "eval-only mode"),
    (["--aug-cfg", "color_jitter=0.4"], "--aug-cfg"),
]


@pytest.mark.parametrize("flags,message", REFUSED, ids=[m for _, m in REFUSED])
def test_main_refuses_what_is_not_ported(tmp_path, monkeypatch, flags, message):
    def no_model(*a, **k):
        raise AssertionError("refused flags must stop main before any model work")

    monkeypatch.setattr(main_mod, "create_model_and_transforms", no_model)
    assert main_mod.main(_argv(str(tmp_path), "refused", *flags)) == 1
    with open(tmp_path / "refused" / "out.log") as f:
        log = f.read()
    assert "ERROR" in log and message in log


FAMILIES = {
    # name -> (flags, the losses metrics.jsonl must hold)
    "coca": (["--model", "coca-S-test", "--coca-caption-loss-weight", "1.5"],
             ("contrastive_loss", "caption_loss")),
    "siglip": (["--siglip", "--dist-impl", "shift"], ()),
    "distill": (["--distill-model", TINY], ("contrastive_loss", "distill_loss")),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_main_trains_the_other_loss_families_and_resumes(tmp_path, family):
    """CoCa (coca-S-test, the caption CE streamed under --ce-impl fused),
    --siglip (--dist-impl at one process changes nothing, as in JAX) and
    distillation from a seeded teacher .pt: rc 0, finite losses with the
    family's terms in metrics.jsonl, a checkpoint a later run resumes."""
    logs = str(tmp_path)
    flags, terms = FAMILIES[family]
    if family == "distill":
        teacher, _ = factory.create_model(TINY, "cpu", torch.float32, seed=5)
        flags = flags + ["--distill-pretrained",
                         checkpoint.save_pt_checkpoint(str(tmp_path / "teacher.pt"), teacher)]
    assert main_mod.main(_argv(logs, family, *flags, epochs=1)) == 0
    assert main_mod.main(_argv(logs, family, *flags, "--resume", "latest")) == 0
    steps, losses = _losses(logs, family)
    assert steps == list(range(1, 9)) and np.isfinite(losses).all()
    with open(os.path.join(logs, family, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    for term in terms:
        assert all(np.isfinite(r[term]) for r in records), term
    with open(os.path.join(logs, family, "out.log")) as f:
        assert "=> resuming checkpoint" in f.read()
    assert sorted(os.listdir(os.path.join(logs, family, "checkpoints"))) == ["epoch_1",
                                                                           "epoch_2"]


def test_main_skips_a_missing_retrieval_suite_and_trains_on(tmp_path):
    """--retrieval-* was refused until eval was ported. A suite whose files
    are missing is logged and skipped, and training goes on, as in the JAX
    entry point; with no suite and no zero-shot there is no eval."""
    argv = _argv(tmp_path, "skip", "--retrieval-coco", "--coco-data-root-dir",
                 str(tmp_path / "no-coco"), "--val-frequency", "1", epochs=1)
    assert main_mod.main(argv) == 0
    base = tmp_path / "skip"
    with open(base / "out.log") as f:
        log = f.read()
    assert "WARNING" in log and "skipping retrieval suite coco" in log
    assert os.path.isdir(base / "checkpoints" / "epoch_1")
    assert not os.path.exists(base / "checkpoints" / "results.jsonl")
    assert _losses(tmp_path, "skip")[0] == [1, 2, 3, 4]


def test_main_imagenet_val_runs_zero_shot(tmp_path):
    """--imagenet-val (refused until eval was ported) runs zero-shot at the
    end of an epoch that --zeroshot-frequency selects; the result line holds
    top-1 and top-5 over the folder's images."""
    from PIL import Image

    val = tmp_path / "val"
    for c in range(3):
        (val / f"n{c}").mkdir(parents=True)
        Image.fromarray(np.full((40, 50, 3), 60 * c, np.uint8)).save(val / f"n{c}" / "a.JPEG")
    (val / "classnames.json").write_text(json.dumps(["red fox", "blue car", "green tree"]))
    argv = _argv(tmp_path, "zs", "--imagenet-val", str(val), "--zeroshot-frequency", "1",
                 epochs=1)
    assert main_mod.main(argv) == 0
    with open(tmp_path / "zs" / "checkpoints" / "results.jsonl") as f:
        (line,) = [json.loads(x) for x in f]
    assert line["epoch"] == 1
    assert 0.0 <= line["imagenet-zeroshot-val-top1"] <= line["imagenet-zeroshot-val-top5"] == 1.0


def test_image_mean_and_std_reach_the_model_and_the_transform(tmp_path, monkeypatch):
    """--image-mean / --image-std override the config's statistics in the
    vision tower's uint8 normalisation and in preprocess_val alike, as in the
    JAX factory; without them both keep the config's."""
    mean, std = (0.5, 0.4, 0.3), (0.25, 0.2, 0.15)
    seen = {}
    real = main_mod.create_model_and_transforms

    def spy(*a, **k):
        seen["out"] = real(*a, **k)
        return seen["out"]

    monkeypatch.setattr(main_mod, "create_model_and_transforms", spy)
    flags = ["--image-mean", *map(str, mean), "--image-std", *map(str, std)]
    assert main_mod.main(_argv(str(tmp_path), "stats", *flags, epochs=1)) == 0
    model, cfg, _, preprocess_val = seen["out"]
    assert cfg.vision_cfg.image_mean == mean and cfg.vision_cfg.image_std == std
    np.testing.assert_allclose(model.visual.image_mean.cpu().numpy(), mean, rtol=1e-7)
    np.testing.assert_allclose(model.visual.image_std.cpu().numpy(), std, rtol=1e-7)
    # a constant image: the transform's output is (value / 255 - mean) / std
    from PIL import Image
    size = cfg.vision_cfg.image_size
    out = np.asarray(preprocess_val(Image.new("RGB", (size, size), (51, 102, 153))))
    want = (np.array([51, 102, 153], np.float32) / 255 - np.array(mean)) / np.array(std)
    np.testing.assert_allclose(out.reshape(-1, 3).mean(0), want, rtol=1e-5, atol=1e-5)
    # the tower normalises a uint8 batch with the same statistics
    raw = np.full((1, size, size, 3), (51, 102, 153), np.uint8)
    host = np.broadcast_to(want.astype(np.float32), raw.shape).copy()
    with torch.no_grad():
        a = model.encode_image(torch.from_numpy(raw), normalize=True)
        b = model.encode_image(torch.from_numpy(host), normalize=True)
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)

    _, default_cfg, _, _ = factory.create_model_and_transforms(TINY, device="cpu",
                                                               precision="fp32")
    assert default_cfg.vision_cfg.image_mean == pytest.approx((0.48145466, 0.4578275, 0.40821073))
    with pytest.raises(ValueError, match="image_mean takes one value a channel"):
        factory.create_model_and_transforms(TINY, device="cpu", image_mean=(0.5,))


def test_main_trains_with_maxsim_impl_streaming_int8(tmp_path):
    """--maxsim-impl streaming_int8 trains the colclip model: the int8 forward
    moves the token loss by quantization noise only (under 2e-2 of the
    default run's, the bar of the int8 scores themselves), and the
    straight-through backward keeps the run finite and falling."""
    logs = str(tmp_path)
    flags = ("--model", TINY + "-colxlip")
    assert main_mod.main(_argv(logs, "int8", *flags, "--maxsim-impl", "streaming_int8",
                               epochs=1)) == 0
    assert main_mod.main(_argv(logs, "default", *flags, epochs=1)) == 0
    (steps, got), (_, want) = _losses(logs, "int8"), _losses(logs, "default")
    assert steps == [1, 2, 3, 4] and np.isfinite(got).all()
    assert got != want
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert os.path.isdir(os.path.join(logs, "int8", "checkpoints", "epoch_1"))


def test_main_trains_local_loss_and_the_ring_on_one_process(tmp_path):
    """--local-loss --token-dist ring --token-neighborhood 2 on one process
    train, as in the JAX entry point: at one device the three flags change
    nothing, so the losses are the default run's."""
    logs = str(tmp_path)
    flags = ("--model", TINY + "-colxlip", "--save-frequency", "0")
    assert main_mod.main(_argv(logs, "recipe", *flags, "--local-loss", "--token-dist", "ring",
                               "--token-neighborhood", "2", epochs=1)) == 0
    assert main_mod.main(_argv(logs, "default", *flags, epochs=1)) == 0
    (steps, got), (_, want) = _losses(logs, "recipe"), _losses(logs, "default")
    assert steps == [1, 2, 3, 4] and got == want


def test_main_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    argv = _argv(str(tmp_path), "nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_mod.main(argv[2:])    # without --device cpu: the default cuda:0
    assert not os.path.exists(tmp_path / "nocard")


def test_main_text_ctx_bounds_and_name(tmp_path):
    assert main_mod.main(_argv(str(tmp_path), "ctx", "--text-ctx", "99")) == 1
    args = params.parse_args(["--model", "ViT-B/16", "--batch-size", "256"])
    name = main_mod.generate_name(args)
    assert name.endswith("-model_ViT-B-16-lr_0.0005-b_256-p_bf16")
    sched = main_mod.build_lr_schedule(params.parse_args(
        ["--lr-scheduler", "const-cooldown", "--epochs", "4", "--epochs-cooldown", "1",
         "--warmup", "2", "--lr", "1e-3"]), 40)
    assert sched(20) == pytest.approx(1e-3) and sched(39) < 1e-3


# ---------------------------------------------------------------------------
# the train state carried across from JAX
# ---------------------------------------------------------------------------

def test_train_one_epoch_from_one_pt_logs_the_jax_losses(tmp_path, monkeypatch):
    """JAX init -> save_pt_checkpoint -> --pretrained on both sides; three
    synthetic steps of each package's train_one_epoch log the same losses."""
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    jmodel, _, jparams, _, _ = jax_create_model_and_transforms(TINY, precision="fp32", seed=11)
    pt = jax_checkpoint.save_pt_checkpoint(str(tmp_path / "init.pt"),
                                           jax.tree.map(np.asarray, jparams))
    jmodel, _, jparams, _, _ = jax_create_model_and_transforms(TINY, pretrained=pt,
                                                               precision="fp32")
    data_cfg = dict(batch_size=8, image_size=(64, 64), context_length=32,
                    num_sampled_captions=2, seed=5, num_samples=64)
    opt_kw = dict(beta1=0.9, beta2=0.98, eps=1e-6, weight_decay=0.2)

    jsched = jax_schedules.cosine_lr(1e-3, 1, 6)
    tx = jax_optim.create_optimizer(jsched, **opt_kw)
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), jparams, tx.init(jparams))
    jstep = jax_ts.make_train_step(
        jmodel, tx, jax_ts.TrainStepConfig(loss_type="clip", ce_impl="fused"), donate=False)
    want = _Collect()
    jax_train.train_one_epoch(
        jstep, state, jax_synthetic.SyntheticDataset(jax_synthetic.SyntheticConfig(**data_cfg)),
        epoch=0, global_batch_size=8, log_every_n_steps=1, writer=want, steps_per_epoch=3,
        lr_schedule=jsched)

    model, _, _, _ = factory.create_model_and_transforms(TINY, pt, device="cpu",
                                                      precision="fp32")
    sched = schedules.cosine_lr(1e-3, 1, 6)
    step = make_train_step(model, optim.create_optimizer(model, sched, **opt_kw), sched,
                           TrainStepConfig(loss_type="clip", ce_impl="fused"))
    got = _Collect()
    steps, _ = train_one_epoch(
        step, synthetic.SyntheticDataset(synthetic.SyntheticConfig(**data_cfg)), epoch=0,
        global_batch_size=8, log_every_n_steps=1, writer=got, steps_per_epoch=3,
        lr_schedule=sched, device="cpu")
    assert steps == 3 and [s for s, _ in got.records] == [s for s, _ in want.records]
    for (_, g), (_, w) in zip(got.records, want.records):
        assert g.keys() == w.keys()
        for key in ("total_loss", "logit_scale", "grad_norm", "lr", "text_trunc_rate", "epoch"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=key)


def test_optax_adamw_state_carries_over(monkeypatch):
    """Two JAX steps, then the params and the AdamW moments move to the port;
    a third step on each side lands on the same parameters."""
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    jmodel, _, jparams, _, _ = jax_create_model_and_transforms(TINY, precision="fp32", seed=2)
    jsched = jax_schedules.cosine_lr(1e-3, 1, 6)
    tx = jax_optim.create_optimizer(jsched, weight_decay=0.1)
    jstep = jax_ts.make_train_step(jmodel, tx, jax_ts.TrainStepConfig(loss_type="clip"),
                                   donate=False)
    data = list(synthetic.SyntheticDataset(synthetic.SyntheticConfig(
        batch_size=4, image_size=(64, 64), context_length=32, seed=9, num_samples=12)))
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), jparams, tx.init(jparams))
    for imgs, txts in data[:2]:
        state, _ = jstep(state, jnp.asarray(imgs), jnp.asarray(txts[:, 0]))
    adam = state.opt_state[0]

    model = factory.create_model(TINY, "cpu", torch.float32)[0].train()
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    sched = schedules.cosine_lr(1e-3, 1, 6)
    opt = optim.create_optimizer(model, sched, weight_decay=0.1)
    step = make_train_step(model, opt, sched, TrainStepConfig(loss_type="clip"))
    step.step = convert.load_optax_adamw_state(
        model, opt, jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        np.asarray(adam.count))
    assert step.step == 2 == int(state.step)

    imgs, txts = data[2]
    state, jmetrics = jstep(state, jnp.asarray(imgs), jnp.asarray(txts[:, 0]))
    metrics = step(torch.from_numpy(imgs), torch.from_numpy(txts[:, 0]))
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jmetrics["total_loss"]),
                               rtol=1e-5)
    want = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)
