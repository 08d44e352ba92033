#!/usr/bin/env python3
"""Convert a checkpoint of the PyTorch port into a reference-loadable .pt
file. The twin of ``scripts/export_pt.py``.

Reads a checkpoint directory of the port (``state.pt``, or a sharded save
read whole) or re-wraps an existing ``.pt``, and writes the OpenCLIP /
ColXLIP torch layout ({'state_dict', 'epoch', 'name'}, fp32 tensors) that
the reference, ``--pretrained`` and the JAX package's ``load_weights`` read.

    python3 scripts/torch_export_pt.py --model ViT-B-16-colxlip \\
        --checkpoint logs/<name>/checkpoints/epoch_32 --out model.pt

The model is built on the card (``--device cuda:0``) unless given
``--device cpu``. Prints {"out", "bytes"} as one JSON object.
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
    p.add_argument("--model", required=True,
                   help="model config name (shapes the state dict template)")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint directory of the port (epoch_N) or .pt file")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--name", default="")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    from colxlip_tpu_torch.cli import load_model, resolve_device
    from colxlip_tpu_torch.training.checkpoint import save_pt_checkpoint

    model, _ = load_model(args.model, args.checkpoint, resolve_device(args.device),
                          precision="fp32")
    out = save_pt_checkpoint(args.out, model, epoch=args.epoch, name=args.name or args.model)
    print(json.dumps({"out": out, "bytes": os.path.getsize(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
