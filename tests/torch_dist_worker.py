"""One rank of the port's data-parallel tests on the CPU (gloo).

    python tests/torch_dist_worker.py <suite> <rank> <world> <port> <inputs> <out_dir> [argv...]

Every rank of a suite runs every case of it on its own rows of the same
seeded inputs and writes ``<out_dir>/rank<r>.npz``; the test files
(``tests/test_torch_dist*.py``) spawn the ranks once per file and hold
the results against the JAX ``shard_map`` functions. Suites:

- ``losses``: the ``LOSS_CASES`` of ``LOSS_SUITES['losses']`` (the
  collectives, clip and colclip);
- ``siglip``: the ``LOSS_CASES`` of ``LOSS_SUITES['siglip']`` (SigLIP's four
  negative exchanges and the distillation loss);
- ``step``: ``STEP_CASES``, one train step each from the same weights;
- ``main``: ``colxlip_tpu_torch.main.main(argv)``; the rank saves its
  final parameters, and with ``--stop-after-step k`` (before ``argv``)
  signals itself SIGUSR1 after its k-th step.

This file imports nothing of the JAX package: the ranks run the port alone.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# name -> (kind, keywords); kinds: 'gather', 'shift', 'clip', 'colclip',
# 'siglip' ('bias' adds a logit_bias), 'distill'
LOSS_CASES = {
    "gather_with_grad": ("gather", dict(gather_with_grad=True)),
    "gather_no_grad": ("gather", dict()),
    "gather_local_loss": ("gather", dict(local_loss=True)),
    "ring_shift_plus_1": ("shift", dict(shift=1)),
    "ring_shift_minus_1": ("shift", dict(shift=-1)),
    "clip_full": ("clip", dict()),
    "clip_full_gather_with_grad": ("clip", dict(gather_with_grad=True)),
    "clip_local": ("clip", dict(local_loss=True)),
    "clip_local_gather_with_grad": ("clip", dict(local_loss=True, gather_with_grad=True)),
    "clip_fused_local": ("clip", dict(local_loss=True, ce_impl="fused")),
    "clip_fused_full": ("clip", dict(ce_impl="fused")),
    "colclip_full": ("colclip", dict()),
    "colclip_full_gather_with_grad": ("colclip", dict(gather_with_grad=True)),
    "colclip_full_valid": ("colclip", dict(mask_mode="valid")),
    "colclip_local_gather": ("colclip", dict(local_loss=True)),
    "colclip_local_gather_valid": ("colclip", dict(local_loss=True, mask_mode="valid")),
    "colclip_ring": ("colclip", dict(local_loss=True, token_dist="ring", gather_with_grad=True)),
    "colclip_ring_cap2": ("colclip", dict(local_loss=True, token_dist="ring",
                                          token_neighborhood=2, gather_with_grad=True)),
    "colclip_ring_valid": ("colclip", dict(local_loss=True, token_dist="ring",
                                           mask_mode="valid", gather_with_grad=True)),
    "colclip_ring_no_grad": ("colclip", dict(local_loss=True, token_dist="ring")),
    "colclip_ring_cap2_no_grad": ("colclip", dict(local_loss=True, token_dist="ring",
                                                  token_neighborhood=2)),
    "siglip_bidir": ("siglip", dict(dist_impl="bidir")),
    "siglip_shift": ("siglip", dict(dist_impl="shift")),
    "siglip_reduce": ("siglip", dict(dist_impl="reduce")),
    "siglip_gather": ("siglip", dict(dist_impl="gather")),
    "siglip_bidir_bias": ("siglip", dict(dist_impl="bidir", bias=True)),
    "siglip_reduce_bias": ("siglip", dict(dist_impl="reduce", bias=True)),
    "distill_full": ("distill", dict()),
    "distill_full_gather_with_grad": ("distill", dict(gather_with_grad=True)),
    "distill_local": ("distill", dict(local_loss=True)),
    "distill_local_gather_with_grad": ("distill", dict(local_loss=True,
                                                       gather_with_grad=True)),
}
LOSS_SUITES = {"losses": ("gather", "shift", "clip", "colclip"), "siglip": ("siglip", "distill")}
LOSS_SCALE = 10.0
LOSS_BIAS = -2.0
LOSS_ALPHA = 0.6

# name -> TrainStepConfig keywords (the colclip loss); 'text_ctx' feeds
# texts shorter than the model's context
STEP_CASES = {
    "gather_with_grad": dict(gather_with_grad=True),
    "no_gather_grad": dict(),
    "accum_freq_2": dict(accum_freq=2),
    "local_ring_cap2": dict(local_loss=True, token_dist="ring", token_neighborhood=2,
                            text_ctx=16),
}
STEP_LR = (1e-3, 10, 100)          # cosine_lr(base, warmup, total)
STEP_WD = 0.1
TINY = "ViT-S-16-test-colxlip"


def rows(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def loss_cases(suite: str) -> list:
    """The names of ``LOSS_CASES`` that ``suite`` runs."""
    return [name for name, (kind, _) in LOSS_CASES.items() if kind in LOSS_SUITES[suite]]


def run_losses(rank: int, world: int, inputs, out: dict, suite: str = "losses") -> None:
    from colxlip_tpu_torch.losses import clip_loss, colclip_loss, distill_clip_loss, siglip_loss
    from colxlip_tpu_torch.parallel.collectives import gather_features, ring_shift

    local = {k: torch.from_numpy(rows(inputs[k], rank, world))
             for k in inputs.files if not k.startswith("cot_")}
    scale = torch.tensor(LOSS_SCALE)
    if suite == "siglip":
        try:
            siglip_loss(local["image"], local["text"], scale, axis_name="data",
                        dist_impl="ring")
        except ValueError as e:
            out["siglip_unknown_dist_impl"] = np.array(str(e))
    for name in loss_cases(suite):
        kind, kw = LOSS_CASES[name]
        if kind in ("siglip", "distill"):
            kw = dict(kw)
            feats = [local[k].clone().requires_grad_(True) for k in ("image", "text")]
            if kind == "siglip":
                bias = (torch.tensor(LOSS_BIAS, requires_grad=True) if kw.pop("bias", False)
                        else None)
                loss = siglip_loss(*feats, scale, bias, axis_name="data", **kw)
                if bias is not None:
                    feats.append(bias)
            else:
                loss = distill_clip_loss(*feats, scale, local["dist_image"], local["dist_text"],
                                         torch.tensor(LOSS_SCALE / 2), axis_name="data",
                                         output_dict=True, **kw)
                out[f"{name}/distill"] = loss["distill_loss"].detach().numpy()
                loss = loss["contrastive_loss"] + loss["distill_loss"]
            loss.backward()
            out[f"{name}/value"] = loss.detach().numpy()
            for i, f in enumerate(feats):
                out[f"{name}/grad{i}"] = f.grad.numpy()
            continue
        if kind in ("gather", "shift"):
            x = local["image"].clone().requires_grad_(True)
            if kind == "gather":
                y = gather_features(x, axis_name="data", **kw)
            else:
                y = ring_shift(x, "data", kw["shift"])
            cot = torch.from_numpy(inputs[f"cot_{kind}"][rank])
            if y.requires_grad:        # local loss: the gathered copy carries none
                (y * cot).sum().backward()
            out[f"{name}/value"] = y.detach().numpy()
            out[f"{name}/grad0"] = (torch.zeros_like(x) if x.grad is None else x.grad).numpy()
            continue
        feats = [local[k].clone().requires_grad_(True)
                 for k in ("image", "text", "token_image", "token_text")]
        if kind == "clip":
            loss = clip_loss(feats[0], feats[1], scale, axis_name="data", **kw)
            feats = feats[:2]
        else:
            loss = colclip_loss(*feats, scale, alpha=LOSS_ALPHA, axis_name="data",
                                text_mask=local["text_mask"], **kw)["total_loss"]
        loss.backward()
        out[f"{name}/value"] = loss.detach().numpy()
        for i, f in enumerate(feats):
            out[f"{name}/grad{i}"] = (f.grad if f.grad is not None
                                      else torch.zeros_like(f)).numpy()


def run_step(rank: int, world: int, inputs, out: dict) -> None:
    from colxlip_tpu_torch import factory
    from colxlip_tpu_torch.models import ColXLIP
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training import optim, schedules

    state = {k[len("param/"):]: torch.from_numpy(inputs[k]) for k in inputs.files
             if k.startswith("param/")}
    images = torch.from_numpy(rows(inputs["images"], rank, world))
    texts_full = torch.from_numpy(rows(inputs["texts"], rank, world))
    for name, kw in STEP_CASES.items():
        kw = dict(kw)
        ctx = kw.pop("text_ctx", None)
        texts = texts_full if ctx is None else torch.from_numpy(
            rows(inputs[f"texts_ctx{ctx}"], rank, world))
        model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
        if rank == 0:
            model.load_state_dict(state, strict=True)
        # the other ranks start from their own random init: the step's
        # broadcast from rank 0 must replace it
        model.train()
        schedule = schedules.cosine_lr(*STEP_LR)
        opt = optim.create_optimizer(model, schedule, weight_decay=STEP_WD)
        cfg = dataclasses.replace(TrainStepConfig(loss_type="colclip"), **kw)
        step = make_train_step(model, opt, schedule, cfg, mesh="data")
        metrics = step(images, texts)
        for k, v in metrics.items():
            out[f"{name}/metric/{k}"] = np.float64(float(v))
        for k, p in model.named_parameters():
            out[f"{name}/param/{k}"] = p.detach().numpy()


def run_main(rank: int, world: int, argv: list, out: dict) -> None:
    from colxlip_tpu_torch import main as main_mod
    from colxlip_tpu_torch.parallel import train_step

    stop_after = None
    if argv and argv[0] == "--stop-after-step":
        stop_after, argv = int(argv[1]), argv[2:]
    steps = []
    build = main_mod.make_train_step

    def capture(*a, **k):
        step = build(*a, **k)
        steps.append(step)
        return step
    main_mod.make_train_step = capture
    if stop_after is not None:
        call = train_step.TrainStep.__call__

        def call_then_signal(self, *a, **k):
            metrics = call(self, *a, **k)
            if self.step == stop_after:
                os.kill(os.getpid(), signal.SIGUSR1)
            return metrics
        train_step.TrainStep.__call__ = call_then_signal
    out["rc"] = np.int64(main_mod.main(argv))
    out["steps_run"] = np.int64(steps[0].step)
    for k, p in steps[0].model.named_parameters():
        out[f"param/{k}"] = p.detach().numpy()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(suite: str, world: int, inputs_path: str, out_dir: str,
                argv=(), timeout: float = 300.0, extra_argv=None) -> list:
    """Run ``world`` ranks of ``suite`` at once (one intra-op thread each)
    and return their results, rank by rank; raises with the ranks' output
    when one fails. ``extra_argv``: rank -> arguments put before ``argv``."""
    import subprocess

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(world):
        cmd = [sys.executable, os.path.abspath(__file__), suite, str(r), str(world), str(port),
               inputs_path, out_dir, *(extra_argv or {}).get(r, ()), *argv]
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env),
                      log))
    failed = []
    try:
        for r, (p, log) in enumerate(procs):
            if p.wait(timeout=timeout) != 0:
                failed.append(r)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "".join(open(os.path.join(out_dir, f"rank{r}.log")).read()[-4000:]
                       for r in failed)
        raise RuntimeError(f"{suite}: rank(s) {failed} failed:\n{logs}")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


def main() -> int:
    suite, rank, world, port, inputs_path, out_dir, *argv = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    out: dict = {}
    if suite == "main":
        # main joins the group itself, from the --dist-* flags
        run_main(rank, world, argv + ["--dist-coordinator", f"127.0.0.1:{port}",
                                      "--dist-num-processes", str(world),
                                      "--dist-process-id", str(rank)], out)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            inputs = np.load(inputs_path)
            if suite == "step":
                run_step(rank, world, inputs, out)
            else:
                run_losses(rank, world, inputs, out, suite)
        finally:
            dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
