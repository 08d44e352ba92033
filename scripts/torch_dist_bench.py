#!/usr/bin/env python3
"""Time the data-parallel train step against the one-device step on one
NVIDIA GPU, under a ``torch.distributed`` NCCL group of one.

    python3 scripts/torch_dist_bench.py [--steps 8] [--rounds 2]

The step of ``chip_smoke.py`` phase 12: ViT-B-16-colxlip, colclip full
mode, bf16, batch 256, learning rate 0 (the weights stay), seed 0. Variants,
each built from the same weights and run in turns, ``--rounds`` times:

- ``one_device``: ``make_train_step(mesh=None)``;
- ``group``: ``make_train_step(mesh=<group>)`` as shipped (one coalesced
  all-reduce of the gradients: flatten, all-reduce, divide, copy back);
- ``group_no_grad_allreduce``: the gradients' all-reduce left out (timing
  only: at one rank it changes no value);
- ``group_no_gather``: the loss's all-gathers replaced by a copy (timing
  only, as above);
- ``group_per_tensor``: one all-reduce and one divide a gradient tensor, no
  flat buffer;
- ``group_persistent``: the flat buffer allocated once and reused.

For each: the median ms of ``--steps`` steps after two warm-up steps (host
clock to ``synchronize()``) and one step under ``torch.profiler`` after one
warm-up: device ms, wall ms, the device's idle share and the device time of
the NCCL kernels. Prints a line a variant, the card's name and power limit
and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def per_tensor_mean_(tensors, group):
    import torch
    import torch.distributed as dist

    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(torch.full((), dist.get_world_size(group), dtype=t.dtype, device=t.device))


def persistent_mean_factory():
    import torch
    import torch.distributed as dist

    buffers = {}

    def mean_(tensors, group):
        n = sum(t.numel() for t in tensors)
        key = (tensors[0].dtype, n)
        if key not in buffers:
            buffers[key] = torch.empty(n, dtype=tensors[0].dtype, device=tensors[0].device)
        flat = buffers[key]
        torch.cat([t.reshape(-1) for t in tensors], out=flat)
        dist.all_reduce(flat, group=group)
        flat.div_(torch.full((), dist.get_world_size(group), dtype=flat.dtype,
                             device=flat.device))
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))
    return mean_


def run_variant(name, dev, ref_state, images, texts, group, steps):
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel import collectives, train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    saved = (train_step.all_reduce_mean_, collectives.all_gather_rows)
    real_mean = train_step.all_reduce_mean_
    if name == "group_no_grad_allreduce":
        # the losses' all-reduce (one stacked tensor of three) stays
        train_step.all_reduce_mean_ = lambda ts, g: None if len(ts) > 1 else real_mean(ts, g)
    elif name == "group_no_gather":
        collectives.all_gather_rows = lambda x, g: x.detach().clone()
    elif name == "group_per_tensor":
        train_step.all_reduce_mean_ = per_tensor_mean_
    elif name == "group_persistent":
        train_step.all_reduce_mean_ = persistent_mean_factory()
    try:
        model, _ = create_model(chip_smoke.MODEL, dev, torch.bfloat16, seed=0)
        model.load_state_dict(ref_state)
        model.train()
        zero = const_lr(0.0, 0)
        step = train_step.make_train_step(
            model, create_optimizer(model, zero), zero,
            train_step.TrainStepConfig(loss_type="colclip"),
            mesh=None if name == "one_device" else group)
        for _ in range(2):
            step(images, texts)
        secs = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(images, texts)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        events, wall_ms = chip_smoke.profiled(lambda: step(images, texts))
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        nccl_ms = sum(e.self_device_time_total for e in kernels
                      if "nccl" in e.key.lower()) / 1e3
        del step, model
        torch.cuda.empty_cache()
    finally:
        train_step.all_reduce_mean_, collectives.all_gather_rows = saved
    return {"ms": statistics.median(secs) * 1e3, "profiled_wall_ms": wall_ms,
            "profiled_device_ms": device_ms, "idle": max(0.0, 1 - device_ms / wall_ms),
            "nccl_device_ms": nccl_ms}


def main() -> int:
    import torch
    import torch.distributed as dist

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_dist_bench: no CUDA device", file=sys.stderr)
        return 2
    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.serving.server import disable_tf32

    disable_tf32()
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{chip_smoke.free_port()}",
                            world_size=1, rank=0)
    try:
        model, cfg = create_model(chip_smoke.MODEL, dev, torch.bfloat16, seed=0)
        ref_state = {k: v.clone() for k, v in model.state_dict().items()}
        del model
        images, texts = chip_smoke.synthetic_batch(
            chip_smoke.TRAIN_BATCH, cfg.vision_cfg.image_size, cfg.text_cfg.context_length,
            seed=12)
        images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
        names = ["one_device", "group", "group_no_grad_allreduce", "group_no_gather",
                 "group_per_tensor", "group_persistent"]
        results = {name: [] for name in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                got = run_variant(name, dev, ref_state, images, texts, dist.group.WORLD,
                                  args.steps)
                results[name].append(got)
                print(f"[dist bench] round {r} {name}: step {got['ms']:.2f} ms; profiled "
                      f"step {got['profiled_device_ms']:.1f} ms of kernels in "
                      f"{got['profiled_wall_ms']:.1f} ms (idle {got['idle']:.1%}), NCCL "
                      f"kernels {got['nccl_device_ms']:.3f} ms ({card})", flush=True)
    finally:
        dist.destroy_process_group()
    print(card, flush=True)
    print(json.dumps({"card": card, "batch": chip_smoke.TRAIN_BATCH, "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
