#!/usr/bin/env python3
"""End-to-end verify drive of the PyTorch port. The twin of
``scripts/verify_drive.py``.

    python3 scripts/torch_verify_drive.py [--device cpu] [--steps 150]

Checks, in order: (1) the attention kernels (#1 forward, #2 backward) on the
card against their plain versions at the vision tower's shape (batch 8, 197
tokens, 12 heads of 64, bf16): forward within 2e-2 (the JAX drive's bar),
backward within 2^-7 of the largest |grad|; (2) a tiny train through the
public API (a ColXLIP model on ``ViT-S-16-test``, ``colclip_loss``, AdamW)
on 16 synthetic correlated pairs, 150 steps: the loss must fall well below
ln 16 (under 2.5) and t2i R@1 must beat chance (3 / 16) through both the
global features and MaxSim scoring. The pairs come from the JAX drive's
seeded generator in the same order. ``--checkpoint`` starts from the weights
of an OpenCLIP-layout ``.pt`` instead of the seeded init. Runs on the card
unless given ``--device cpu`` (where the kernels' plain versions run).
Prints ``VERIFY DRIVE OK`` and exits 0 when every check holds.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MODEL = "ViT-S-16-test"
PAIRS = 16


def check_attention(device, rng):
    """Step 1: (forward max|err|, backward max|err| / max|grad|) of the
    attention kernels against their plain versions; draws the qkv from
    ``rng`` as the JAX drive does."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.ops import attention

    qkv = torch.from_numpy(rng.standard_normal((8, 197, 3 * 768)).astype(np.float32))
    qkv = qkv.to(device, torch.bfloat16).requires_grad_()
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 197, 768))
                            .astype(np.float32)).to(device, torch.bfloat16)
    out = attention.fused_mha_packed(qkv, 12, False)
    (grad,) = torch.autograd.grad(out, qkv, dout)
    with torch.no_grad():
        want = attention.fused_mha_plain(qkv, 12, False)
        want_grad = attention.fused_mha_bwd_plain(qkv, dout, 12, False)
    fwd = (out.float() - want.float()).abs().max().item()
    bwd = ((grad.float() - want_grad.float()).abs().max()
           / want_grad.float().abs().max()).item()
    return fwd, bwd


def pairs(rng, cfg):
    """The 16 correlated pairs of the JAX drive: class-dependent image means
    and five distinct text tokens a caption."""
    import numpy as np

    size = cfg.vision_cfg.image_size
    images = rng.standard_normal((PAIRS, size, size, 3)) * 0.2
    images += np.arange(PAIRS)[:, None, None, None] * 0.15
    texts = np.zeros((PAIRS, cfg.text_cfg.context_length), np.int32)
    texts[:, 0] = 49406
    for i in range(PAIRS):
        texts[i, 1:6] = 100 + 7 * i + np.arange(5)
        texts[i, 6] = 49407
    return images.astype(np.float32), texts


def train_drive(device, rng, *, steps: int = 150, precision: str = "bf16",
                checkpoint=None) -> dict:
    """Step 2: {'losses': [(step, loss)] at steps 0, 25, ... and the last,
    'r1_global', 'r1_maxsim'} of the tiny train."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.cli import colxlip_model
    from colxlip_tpu_torch.losses.colclip import colclip_loss
    from colxlip_tpu_torch.ops.maxsim import maxsim
    from colxlip_tpu_torch.training.optim import AdamW

    model = colxlip_model(MODEL, device, precision=precision, checkpoint=checkpoint)
    images_np, texts_np = pairs(rng, model.cfg)
    images = torch.from_numpy(images_np).to(device)
    texts = torch.from_numpy(texts_np).long().to(device)
    # optax.adamw(1e-3, weight_decay=0.01): every parameter decays
    opt = AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    losses = []
    for i in range(steps):
        out = model(images, texts)
        loss = colclip_loss(out["image_features"], out["text_features"],
                            out["token_image_features"], out["token_text_features"],
                            out["logit_scale"])["total_loss"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 25 == 0 or i == steps - 1:
            losses.append((i, loss.item()))
            print(f"step {i}: loss {losses[-1][1]:.4f}")
    with torch.no_grad():
        out = model(images, texts)
        cls = np.arange(PAIRS)
        sim_global = (out["text_features"].float() @ out["image_features"].float().T)
        sim_maxsim = maxsim(out["token_text_features"].float(),
                            out["token_image_features"].float(), mask_mode="plain")
        r1 = [float(np.mean(s.argmax(dim=1).cpu().numpy() == cls))
              for s in (sim_global, sim_maxsim)]
    return {"losses": losses, "r1_global": r1[0], "r1_maxsim": r1[1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    import numpy as np

    from colxlip_tpu_torch.cli import resolve_device

    device = resolve_device(args.device)
    print("device:", device)
    rng = np.random.default_rng(0)
    fwd, bwd = check_attention(device, rng)
    print(f"attention kernels against their plain versions: forward max|err| {fwd:.2e} "
          f"(bar 2e-2), backward max|err| / max|grad| {bwd:.2e} (bar {2.0 ** -7:.2e})")
    if not (fwd < 2e-2 and bwd <= 2.0 ** -7):
        raise RuntimeError("attention kernels disagree with their plain versions")

    drive = train_drive(device, rng, steps=args.steps, precision=args.precision,
                        checkpoint=args.checkpoint)
    chance = 1.0 / PAIRS
    print(f"t2i R@1 global={drive['r1_global']:.3f} maxsim={drive['r1_maxsim']:.3f} "
          f"(chance {chance:.4f})")
    last = drive["losses"][-1][1]
    if not (math.isfinite(last) and last < 2.5):
        raise RuntimeError(f"loss did not fall below 2.5 (ln 16 = 2.77): {drive['losses']}")
    if not (drive["r1_global"] >= 3 * chance and drive["r1_maxsim"] >= 3 * chance):
        raise RuntimeError("retrieval did not beat chance")
    print("VERIFY DRIVE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
