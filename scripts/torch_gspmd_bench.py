#!/usr/bin/env python3
"""Split the sharded train step's time against the one-device step on one
NVIDIA GPU, under a ``torch.distributed`` NCCL group of one.

    python3 scripts/torch_gspmd_bench.py [--steps 3] [--top 22]

The step of ``chip_smoke.py`` phase 16: ViT-B-16-colxlip, colclip with the
gather carrying gradient, bf16, batch 256, learning rate 0 (the weights
stay), seed 0. Variants, each built from the same weights after the last
is freed:

- ``one``: ``make_train_step`` on one device;
- ``fsdp``: ``shard_state`` + ``make_train_step_gspmd(fsdp=True)`` on a
  ``('data',)`` mesh of one;
- ``tp``: the same on a ``('data', 'model')`` mesh of 1 x 1 (the TP plan).

For each, after two warm-up steps, the median ms of ``--steps`` runs
(host clock to ``synchronize()``) of the whole step, the forward without
gradients, the forward and backward, ``grad_norm`` and ``optimizer.step``
alone, the host time of ``optimizer.step`` (no wait), and the ``--top``
host operations of one profiled step by self CPU time. Prints a line an
item, the card's name and power limit and one JSON object.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def timed(fn, runs: int) -> float:
    import torch

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def variant(name, mesh, ref, images, texts, cfg, args, dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel import gspmd
    from colxlip_tpu_torch.parallel.train_step import compute_loss, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer, global_norm
    from colxlip_tpu_torch.training.schedules import const_lr

    model, _ = create_model(chip_smoke.MODEL, dev, torch.bfloat16, seed=0)
    model.load_state_dict(ref)
    model.train()
    zero = const_lr(0.0, 0)
    if mesh is None:
        opt = create_optimizer(model, zero)
        step = make_train_step(model, opt, zero, cfg)
    else:
        gspmd.shard_state(model, mesh, fsdp=True)
        opt = create_optimizer(model, zero)
        step = gspmd.make_train_step_gspmd(model, opt, zero, cfg, mesh, fsdp=True)
    for _ in range(2):
        step(images, texts)
    params = list(model.parameters())

    def forward():
        with torch.no_grad():
            model(images, texts)

    def forward_backward():
        for p in params:
            p.grad = None
        out = step.forward(images, texts)
        compute_loss(out, cfg, None)["total_loss"].backward()

    res = {"step_ms": timed(lambda: step(images, texts), args.steps),
           "forward_ms": timed(forward, args.steps),
           "forward_backward_ms": timed(forward_backward, args.steps)}
    forward_backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    res["grad_norm_ms"] = timed(lambda: global_norm(p.grad for p in params), args.steps)
    res["optimizer_ms"] = timed(opt.step, args.steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.step()
    res["optimizer_host_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    chip_smoke.log(f"[gspmd {name}] " + ", ".join(f"{k} {v:.1f}" for k, v in res.items()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(images, texts)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:args.top]
    res["host_top_ms"] = {e.key: e.self_cpu_time_total / 1e3 for e in top}
    for e in top:
        chip_smoke.log(f"[gspmd {name}]   self cpu {e.self_cpu_time_total / 1e3:8.2f} ms  "
                       f"x{e.count:5d}  {e.key[:80]}")
    del step, opt, model
    torch.cuda.empty_cache()
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=22)
    args = parser.parse_args()

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.mesh import create_mesh
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig
    from colxlip_tpu_torch.serving.server import disable_tf32

    if not torch.cuda.is_available():
        print("torch_gspmd_bench: no CUDA device", file=sys.stderr)
        return 2
    disable_tf32()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = chip_smoke.card_line()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{chip_smoke.free_port()}",
                            world_size=1, rank=0)
    try:
        model, cfg_m = create_model(chip_smoke.MODEL, dev, torch.bfloat16, seed=0)
        ref = copy.deepcopy(model.state_dict())
        del model
        images, texts = chip_smoke.synthetic_batch(
            chip_smoke.TRAIN_BATCH, cfg_m.vision_cfg.image_size, cfg_m.text_cfg.context_length,
            seed=12)
        images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
        cfg = TrainStepConfig(loss_type="colclip", gather_with_grad=True)
        meshes = {"one": None, "fsdp": create_mesh(1),
                  "tp": init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))}
        out = {name: variant(name, mesh, ref, images, texts, cfg, args, dev)
               for name, mesh in meshes.items()}
    finally:
        dist.destroy_process_group()
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
