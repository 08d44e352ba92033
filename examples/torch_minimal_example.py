"""Minimal usage example of the PyTorch port: the twin of
``examples/minimal_example.py``.

Loads a ColXLIP model (pretrained checkpoint optional), scores a few captions
against one image, and compares late-interaction against plain-CLIP scoring.

Run:  python examples/torch_minimal_example.py [checkpoint.pt] [--device cpu]

It runs on the card (``--device cuda:0``) unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MODEL = "ViT-B-32-colxlip"
CAPTIONS = [
    "a photo of a cat",
    "a photo of a dog",
    "a city street at night with neon lights",
    "a bowl of fresh fruit on a wooden table",
]


def run(model_name: str = MODEL, pretrained=None, device: str = "cuda:0"):
    """(late-interaction probabilities [1, 4], plain-CLIP probabilities
    [1, 4]) of the four captions against one synthetic image, in fp32."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.cli import resolve_device
    from colxlip_tpu_torch.factory import create_model_and_transforms, get_tokenizer

    dev = resolve_device(device)
    model, cfg, _, preprocess_val = create_model_and_transforms(
        model_name, pretrained=pretrained, device=dev, precision="fp32")
    model.eval()
    tokenizer = get_tokenizer(model_name)

    # one synthetic "image" (drop in a real file with PIL.Image.open + preprocess_val)
    size = cfg.vision_cfg.image_size
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.standard_normal((1, size, size, 3)).astype(np.float32)).to(dev)
    texts = torch.from_numpy(tokenizer(CAPTIONS)).long().to(dev)
    with torch.inference_mode():
        logits, _ = model.get_logits(image, texts)
        clip_logits, _ = model.get_logits_as_clip(image, texts)
    return (torch.softmax(logits, dim=-1).cpu().numpy(),
            torch.softmax(clip_logits, dim=-1).cpu().numpy())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("pretrained", nargs="?", default=None)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    late, clip = run(MODEL, args.pretrained, args.device)
    print("late-interaction probs:", late[0])
    print("plain-CLIP probs:      ", clip[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
