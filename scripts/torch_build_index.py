#!/usr/bin/env python3
"""Build / query a late-interaction retrieval index from an image folder with
the PyTorch port. The twin of ``scripts/build_index.py``.

Build: encode every image under --images with the vision tower (eval
transform, batches of --batch-size) and write a
``colxlip_tpu_torch.serving.index`` directory, which either package opens.
Query: load the index and run the two-stage (global shortlist -> MaxSim
rerank) search for text queries, the search the server answers on
POST /v1/search (--index).

    python3 scripts/torch_build_index.py build --model ViT-B-16-colxlip \\
        --checkpoint model.pt --images /data/corpus --out /data/corpus.index
    python3 scripts/torch_build_index.py search --model ViT-B-16-colxlip \\
        --checkpoint model.pt --index /data/corpus.index \\
        --query "a dog catching a frisbee" -k 10

``--checkpoint`` is an OpenCLIP-layout ``.pt`` or a checkpoint directory of
the port; without it the weights are the seeded random init. Every command
runs on the card (``--device cuda:0``) unless given ``--device cpu``.
``--query`` takes one or more queries; each prints its ranked lines
(``rank  score  id``), after a ``query: ...`` line when there are several.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def _model(args):
    from colxlip_tpu_torch.cli import load_model, resolve_device

    device = resolve_device(args.device)
    model, cfg = load_model(args.model, args.checkpoint, device, precision=args.precision)
    return model, cfg, device


def cmd_build(args) -> None:
    from PIL import Image, UnidentifiedImageError

    from colxlip_tpu_torch.data.transforms import image_transform
    from colxlip_tpu_torch.serving.index import build_image_index

    model, cfg, device = _model(args)
    transform = image_transform(cfg.vision_cfg.image_size, is_train=False,
                                mean=cfg.vision_cfg.image_mean, std=cfg.vision_cfg.image_std)
    paths = sorted(os.path.join(r, f) for r, _, files in os.walk(args.images)
                   for f in files if f.lower().endswith(_EXTS))
    if not paths:
        raise SystemExit(f"no images under {args.images}")
    imgs, ids = [], []
    for p in paths:
        try:
            with Image.open(p) as img:
                arr = transform(img)
        except (UnidentifiedImageError, OSError) as e:   # an unreadable file
            print(f"skip {p}: {e}", file=sys.stderr)
            continue
        imgs.append(arr)
        ids.append(os.path.relpath(p, args.images))
    out = build_image_index(model, imgs, args.out, device=device, ids=ids,
                            batch_size=args.batch_size, model_name=args.model)
    print(json.dumps({"index": out, "items": len(ids)}))


def cmd_search(args) -> None:
    import torch

    from colxlip_tpu_torch.data.tokenizer import get_tokenizer_cached
    from colxlip_tpu_torch.serving.index import RetrievalIndex

    model, cfg, device = _model(args)
    idx = RetrievalIndex(args.index, device=device)
    tok = get_tokenizer_cached(cfg.text_cfg.context_length)
    for query in args.query:
        tokens = torch.from_numpy(tok([query])).long().to(device)
        with torch.inference_mode():
            out = model.encode_text(tokens, normalize=True)
        pooled, q_tokens = out if isinstance(out, tuple) else (out, None)
        top, scores, ids = idx.search(
            pooled.float().cpu().numpy(),
            None if q_tokens is None else q_tokens.float().cpu().numpy(),
            k=args.k, shortlist=args.shortlist, scoring=args.scoring, alpha=args.alpha)
        if len(args.query) > 1:
            print(f"query: {query}")
        for rank, (i, s) in enumerate(zip(top[0], scores[0]), 1):
            name = ids[0][rank - 1] if ids else int(i)
            print(f"{rank:3d}  {s:8.3f}  {name}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("build", cmd_build), ("search", cmd_search)):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--model", default="ViT-B-16-colxlip")
        sp.add_argument("--checkpoint", default=None)
        sp.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
        sp.add_argument("--device", default="cuda:0")
        if name == "build":
            sp.add_argument("--images", required=True)
            sp.add_argument("--out", required=True)
            sp.add_argument("--batch-size", type=int, default=256)
        else:
            sp.add_argument("--index", required=True)
            sp.add_argument("--query", required=True, nargs="+")
            sp.add_argument("-k", type=int, default=10)
            sp.add_argument("--shortlist", type=int, default=100)
            sp.add_argument("--scoring", default="maxsim",
                            choices=["global", "maxsim", "mixed"])
            sp.add_argument("--alpha", type=float, default=0.5)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
