#!/usr/bin/env python3
"""Caption images with a CoCa model of the PyTorch port
(``colxlip_tpu_torch/serving/generate.py``). The twin of
``scripts/generate_captions.py``.

    python3 scripts/torch_generate_captions.py --model coca_ViT-B-32 \\
        --checkpoint model.pt --images img1.jpg img2.jpg \\
        [--method top_k --temperature 0.7] [--device cpu]

``--checkpoint`` is an OpenCLIP-layout ``.pt`` or a checkpoint directory of
the port; without it the weights are the seeded random init (``--seed``).
The random methods draw from a ``torch.Generator`` seeded with ``--seed``.
Runs on the card (``--device cuda:0``) unless given ``--device cpu``. Prints
``path<TAB>caption`` a line.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="coca-S-test")
    p.add_argument("--checkpoint", default=None,
                   help=".pt or checkpoint directory; random init if omitted")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--method", default="greedy", choices=["greedy", "top_k", "top_p"])
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from colxlip_tpu_torch.cli import load_model, resolve_device
    from colxlip_tpu_torch.data.tokenizer import SimpleTokenizer
    from colxlip_tpu_torch.data.transforms import image_transform
    from colxlip_tpu_torch.serving.generate import generate_captions, tokens_to_text

    model, cfg = load_model(args.model, args.checkpoint, resolve_device(args.device),
                            precision=args.precision, seed=args.seed)
    transform = image_transform(cfg.vision_cfg.image_size, is_train=False,
                                mean=cfg.vision_cfg.image_mean, std=cfg.vision_cfg.image_std)
    images = []
    for path in args.images:
        with Image.open(path) as img:
            images.append(transform(img))
    tokens = generate_captions(model, np.stack(images), max_len=args.max_len,
                               method=args.method, top_k=args.top_k, top_p=args.top_p,
                               temperature=args.temperature, seed=args.seed)
    tok = SimpleTokenizer(context_length=cfg.text_cfg.context_length)
    for path, caption in zip(args.images, tokens_to_text(tokens, tok)):
        print(f"{path}\t{caption}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
