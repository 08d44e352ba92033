"""``--async-checkpoint``: ``training/checkpoint.py`` ``save_checkpoint_async``
and ``wait_for_saves`` on the CPU, with the JAX semantics
(``colxlip_tpu/training/checkpoint.py``): an async save loads bit-equal to a
synchronous save of the same state (fp32 and 'pure_bf16' state, and the
``epoch_latest`` written from the same snapshot); a writer that raises makes
``wait_for_saves`` raise ``RuntimeError("async checkpoint save failed")``
once, and ``main`` exit with the error; rotation waits for the save that
supersedes the old checkpoints; a parameter changed in place after the call
returns does not reach the file. The writer is held on an event where the
order matters, so no test depends on thread timing. ``main
--async-checkpoint`` over 3 epochs with rotation and ``epoch_latest``: each
async checkpoint bit-equal to a synchronous save of the same state taken
just before it, and ``--resume latest`` goes on at the right step.
"""
from __future__ import annotations

import copy
import json
import os
import threading

import pytest
import torch

from colxlip_tpu_torch import factory
from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch.training import checkpoint, optim

TINY = "ViT-S-16-test"


def _state(precision="fp32", seed=0):
    """A model and an AdamW that has taken one step on seeded gradients."""
    model, _ = factory.create_model(TINY, "cpu", factory.compute_dtype(precision), seed=seed,
                                    param_dtype=factory.param_dtype(precision))
    opt = optim.create_optimizer(model, 1e-3, weight_decay=0.1)
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen).to(p.dtype)
    opt.step()
    return model, opt


def _assert_same(a, b, where="state"):
    assert type(a) is type(b), where
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.fixture
def held_writer(monkeypatch):
    """The background writer (not the test's own synchronous saves) waits on
    the returned event before it writes."""
    release = threading.Event()
    real = checkpoint.save_checkpoint

    def held(*args, **kwargs):
        if threading.current_thread() is not threading.main_thread():
            assert release.wait(timeout=60)
        return real(*args, **kwargs)

    monkeypatch.setattr(checkpoint, "save_checkpoint", held)
    yield release
    release.set()
    checkpoint.wait_for_saves()


@pytest.mark.parametrize("precision", ["fp32", "pure_bf16"])
def test_async_save_loads_bit_equal_to_a_sync_save(tmp_path, precision):
    model, opt = _state(precision)
    state = checkpoint.train_state(model, opt, 7)
    checkpoint.save_checkpoint(str(tmp_path / "sync"), state, epoch=3, name="run")
    checkpoint.save_checkpoint_async(str(tmp_path / "async"), state, epoch=3, name="run",
                                     also_most_recent=True)
    assert checkpoint.ASYNC_SECONDS["snapshot"] >= 0.0
    checkpoint.wait_for_saves()
    assert checkpoint.ASYNC_SECONDS["write"] > 0.0
    assert sorted(os.listdir(tmp_path / "async")) == ["epoch_3", "epoch_latest"]
    want = checkpoint.load_native_checkpoint(str(tmp_path / "sync" / "epoch_3"))
    for tag in ("epoch_3", "epoch_latest"):
        _assert_same(checkpoint.load_native_checkpoint(str(tmp_path / "async" / tag)), want)
    if precision == "pure_bf16":
        sd = want["state"]["state_dict"]
        assert sd["visual.conv1.weight"].dtype == torch.bfloat16
        assert sd["visual.ln_pre.weight"].dtype == torch.float32
    # and it resumes: a fresh model and optimizer take the state back exactly
    fresh, fresh_opt = _state(precision, seed=1)
    assert checkpoint.restore_train_state(want["state"], fresh, fresh_opt) == 7
    _assert_same(checkpoint.train_state(fresh, fresh_opt, 7), state)


def test_a_failed_background_write_is_raised_by_wait_for_saves(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "save_checkpoint", broken)
    model, opt = _state()
    checkpoint.save_checkpoint_async(str(tmp_path), checkpoint.train_state(model, opt, 1),
                                     epoch=1)
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as err:
        checkpoint.wait_for_saves()
    assert isinstance(err.value.__cause__, OSError)
    checkpoint.wait_for_saves()                  # raised once, then cleared


def test_rotation_waits_for_the_superseding_save(tmp_path, held_writer):
    model, opt = _state()
    state = checkpoint.train_state(model, opt, 1)
    checkpoint.save_checkpoint(str(tmp_path), state, epoch=1)
    checkpoint.save_checkpoint_async(str(tmp_path), state, epoch=2, rotate_keep_epoch=2)
    assert sorted(os.listdir(tmp_path)) == ["epoch_1"]     # the save of epoch 2 is held
    held_writer.set()
    checkpoint.wait_for_saves()
    assert sorted(os.listdir(tmp_path)) == ["epoch_2"]


def test_an_in_place_update_after_the_call_does_not_reach_the_file(tmp_path, held_writer):
    model, opt = _state()
    before = copy.deepcopy(model.state_dict())
    order = [p for group in opt.param_groups for p in group["params"]]   # state_dict's ids
    moments = [opt.state[p]["exp_avg"].clone() for p in order]
    checkpoint.save_checkpoint_async(str(tmp_path), checkpoint.train_state(model, opt, 1),
                                     epoch=1)
    with torch.no_grad():                        # the next step, while the write is held
        for p in model.parameters():
            p.add_(1.0)
            opt.state[p]["exp_avg"].add_(1.0)
    held_writer.set()
    checkpoint.wait_for_saves()
    saved = checkpoint.load_native_checkpoint(str(tmp_path / "epoch_1"))["state"]
    _assert_same(saved["state_dict"], before)
    for i, m in enumerate(moments):
        assert torch.equal(saved["optimizer"]["state"][i]["exp_avg"], m)


def _argv(logs, epochs, *extra):
    return ["--device", "cpu", "--model", TINY, "--dataset-type", "synthetic",
            "--train-num-samples", "16", "--batch-size", "8", "--epochs", str(epochs),
            "--lr", "1e-3", "--warmup", "1", "--precision", "fp32", "--logs", str(logs),
            "--name", "run", "--workers", "0", "--log-every-n-steps", "1",
            "--save-frequency", "1", "--seed", "0", "--async-checkpoint", *extra]


def test_main_async_checkpoint_saves_bit_equal_to_sync_saves_and_resumes(tmp_path,
                                                                          monkeypatch):
    side, ckpts = tmp_path / "sync", tmp_path / "run" / "checkpoints"
    real, saved = main_mod.save_checkpoint_async, []

    def beside(checkpoint_dir, state, *, epoch, **kw):
        """A synchronous save of the same state first, then the async one."""
        checkpoint.save_checkpoint(str(side), state, epoch=epoch, name=kw["name"])
        real(checkpoint_dir, state, epoch=epoch, **kw)
        checkpoint.wait_for_saves()       # before the rotation of the next save
        for tag in (f"epoch_{epoch}", "epoch_latest"):
            _assert_same(checkpoint.load_native_checkpoint(str(ckpts / tag)),
                         checkpoint.load_native_checkpoint(str(side / f"epoch_{epoch}")))
        saved.append(epoch)

    monkeypatch.setattr(main_mod, "save_checkpoint_async", beside)
    flags = ("--save-most-recent", "--delete-previous-checkpoint")
    assert main_mod.main(_argv(tmp_path, 3, *flags)) == 0
    assert saved == [1, 2, 3]
    assert sorted(os.listdir(ckpts)) == ["epoch_3", "epoch_latest"]
    monkeypatch.setattr(main_mod, "save_checkpoint_async", real)
    assert main_mod.main(_argv(tmp_path, 4, *flags, "--resume", "latest")) == 0
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == list(range(1, 9))
    assert sorted(os.listdir(ckpts)) == ["epoch_4", "epoch_latest"]


def test_main_exits_with_the_error_when_a_background_save_fails(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "save_checkpoint", broken)
    argv = _argv(tmp_path, 1)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        main_mod.main(argv)
    assert not os.path.exists(tmp_path / "run" / "checkpoints" / "epoch_1")
