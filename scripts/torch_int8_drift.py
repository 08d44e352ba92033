#!/usr/bin/env python3
"""Short-horizon loss-trajectory drift of the int8 forward paths against bf16,
on the PyTorch port. The twin of ``scripts/int8_drift.py``.

Drives a colclip train loop (a ColXLIP model on ``--model``, synthetic
correlated pairs, fixed seed) and prints the loss trajectory as one JSON
line; run once a configuration and compare:

    python3 scripts/torch_int8_drift.py
    COLXLIP_MLP_INT8=fwd python3 scripts/torch_int8_drift.py
    python3 scripts/torch_int8_drift.py --maxsim-impl streaming_int8

The int8 knobs change the forward only (straight-through or recomputed
backward: ``ops/quantization.py``, ``ops/maxsim.py``), so the drift
measures how that forward noise steers the optimization. ``--checkpoint``
starts from the weights of an OpenCLIP-layout ``.pt`` instead of the seeded
init. Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pools(cfg, batch: int, image_size: int, n: int):
    """The JAX drift's ``n`` distinct batches: noise images with a
    class-dependent offset, captions of eight class-dependent tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for k in range(n):
        imgs = rng.standard_normal((batch, image_size, image_size, 3)).astype(np.float32) * 0.3
        cls = np.arange(batch) + k * batch
        imgs += (cls % 97)[:, None, None, None].astype(np.float32) * 0.02
        txts = np.zeros((batch, cfg.text_cfg.context_length), np.int32)
        txts[:, 0] = 49406
        txts[:, 1:9] = (100 + 13 * cls[:, None] + np.arange(8)) % 49000 + 1
        txts[:, 9] = 49407
        out.append((imgs, txts))
    return out


def drift(args) -> dict:
    """{'trajectory': [(step, loss)] unrounded, 'wall_s'}."""
    import torch

    from colxlip_tpu_torch.cli import colxlip_model, resolve_device
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import cosine_lr

    device = resolve_device(args.device)
    model = colxlip_model(args.model, device, precision=args.precision,
                          checkpoint=args.checkpoint)
    batches = [(torch.from_numpy(i).to(device), torch.from_numpy(t).long().to(device))
               for i, t in pools(model.cfg, args.batch_size, args.image_size, args.pool_batches)]
    schedule = cosine_lr(1e-4, 20, args.steps)
    step = make_train_step(model, create_optimizer(model, schedule, weight_decay=0.2),
                           schedule, TrainStepConfig(loss_type="colclip",
                                                     maxsim_impl=args.maxsim_impl))
    traj = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        metrics = step(*batches[i % args.pool_batches])
        if i % args.log_every == 0 or i == args.steps - 1:
            traj.append((i, metrics["total_loss"].item()))
    return {"trajectory": traj, "wall_s": time.perf_counter() - t0}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="ViT-B-16-colxlip")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--pool-batches", type=int, default=8,
                   help="number of distinct device-resident batches cycled "
                        "(data repeats, so the loss can actually fall)")
    p.add_argument("--maxsim-impl", default="auto",
                   choices=["auto", "xla", "streaming", "streaming_int8", "chunked", "pallas"])
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = drift(args)
    traj = out["trajectory"]
    print(json.dumps({
        "config": {"mlp_int8": os.environ.get("COLXLIP_MLP_INT8", ""),
                   "maxsim_impl": args.maxsim_impl, "model": args.model,
                   "batch": args.batch_size, "steps": args.steps},
        "trajectory": [[i, round(v, 4)] for i, v in traj],
        "final_loss": round(traj[-1][1], 4),
        "wall_s": round(out["wall_s"], 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
