#!/usr/bin/env python3
"""Export a checkpoint of the PyTorch port as a self-contained serving bundle
of both towers (``torch.export``; the format is in
``colxlip_tpu_torch/serving/aot.py``). The twin of ``scripts/export_aot.py``.

    python3 scripts/torch_export_aot.py --model ViT-B-16-colxlip \\
        --checkpoint logs/<name>/checkpoints/epoch_32 --out bundle \\
        [--static-batch 64] [--uint8-images] [--device cuda:0]

``--checkpoint`` is a checkpoint directory of the port (``state.pt`` or a
sharded save) or an OpenCLIP-layout ``.pt``; without it the weights are the
seeded random init. The bundle runs on the device type it was exported on
(``--device``, the card unless told otherwise). Prints the bundle's meta as
one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory or .pt (default: seeded random init)")
    p.add_argument("--out", required=True, help="output bundle directory")
    p.add_argument("--static-batch", type=int, default=None,
                   help="pin the batch dim (default: symbolic, any batch)")
    p.add_argument("--uint8-images", action="store_true",
                   help="the image entry takes uint8 (normalised on the device)")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--force-quick-gelu", action="store_true")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    import torch

    from colxlip_tpu_torch.factory import compute_dtype, create_model, load_weights
    from colxlip_tpu_torch.serving.aot import save_aot_bundle
    from colxlip_tpu_torch.training.checkpoint import load_native_checkpoint

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to export a bundle for the CPU)")
    model, cfg = create_model(args.model, device, compute_dtype(args.precision),
                              quick_gelu=True if args.force_quick_gelu else None)
    if args.checkpoint is None:
        print("WARNING: exporting RANDOM-INIT weights (no --checkpoint)", file=sys.stderr)
    elif os.path.isdir(args.checkpoint):
        model.load_state_dict(load_native_checkpoint(args.checkpoint)["state"]["state_dict"],
                              strict=True)
    else:
        load_weights(model, args.checkpoint)
    meta = save_aot_bundle(args.out, model, cfg, model_name=args.model,
                           static_batch=args.static_batch, uint8_images=args.uint8_images)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
