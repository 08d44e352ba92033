#!/usr/bin/env python3
"""Tokenized caption-length distribution, through the PyTorch port's
tokenizer and caption sampler. The twin of ``scripts/caption_length_stats.py``
(the same report, line for line, on the same inputs).

The text tower computes its whole fixed context (77 tokens) whatever a
caption's length; if the feed's captions are mostly much shorter, a shorter
``--text-ctx`` bucket cuts the text tower's work. This measures the
distribution:

  - from the vendored eval annotation JSONs (COCO-style short web captions
    and Urban1k-style long captions), and/or
  - from a webdataset shard spec through the train caption sampler
    (--train-data), the distribution the train step sees after the
    sentence split and random merge.

Lengths include the SOT / EOT specials: the context a bucket must cover.
Host-side only (the tokenizer and the sampler): no device is used.

    python3 scripts/torch_caption_length_stats.py [--train-data '/data/s-{0000..0003}.tar']
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import random
import sys
import tarfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from colxlip_tpu_torch.data.captions import (  # noqa: E402
    collect_captions, sample_diverse_captions)
from colxlip_tpu_torch.data.tokenizer import SimpleTokenizer  # noqa: E402
from colxlip_tpu_torch.data.wds import expand_urls  # noqa: E402


def token_lengths(tokenizer, captions):
    """EOT position + 1 of each caption at a context of 77 (EOT is the
    largest id, so argmax finds it)."""
    return np.argmax(tokenizer(list(captions)), axis=1) + 1


def estimated_bpe_lengths(captions):
    """CLIP-BPE length estimate from word counts (about 1.3 BPE tokens a word
    for English web text, plus SOT / EOT), for when the merges asset is
    absent: the zero-merges byte fallback inflates counts about 3x."""
    return np.array([min(77, int(round(len(c.split()) * 1.3)) + 2) for c in captions])


def report(name, lengths, buckets):
    lengths = np.asarray(lengths)
    row = {
        "source": name,
        "n": int(lengths.size),
        "mean": round(float(lengths.mean()), 1),
        "percentiles": {p: int(np.percentile(lengths, p)) for p in (50, 75, 90, 95, 99)},
        "at_cap_77": round(float((lengths >= 77).mean()), 4),
    }
    for b in buckets:
        row[f"fits_{b}"] = round(float((lengths <= b).mean()), 4)
    print(json.dumps(row))
    return row


def _measure(tok, name, captions, buckets, estimated=None):
    """The report of ``captions`` under ``name``; without the merges asset,
    of their estimated lengths under ``estimated``."""
    if tok.has_merges:
        return report(name, token_lengths(tok, captions), buckets)
    return report(estimated or f"{name} (BPE-estimated: no merges asset)",
                  estimated_bpe_lengths(captions), buckets)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train-data", default=None,
                    help="wds shard spec: measure the train feed's post-merge caption lengths")
    ap.add_argument("--num-samples", type=int, default=2000)
    ap.add_argument("--buckets", type=int, nargs="*", default=[24, 32, 48, 64])
    ap.add_argument("--max-merged-num", type=int, default=3)
    args = ap.parse_args(argv)

    tok = SimpleTokenizer(context_length=77)
    suites = {
        "coco_val2017": (os.path.join(REPO, "datasets/coco/annotations/captions_val2017.json"),
                         lambda d: [a["caption"] for a in d["annotations"]]),
        "urban1k": (os.path.join(REPO, "datasets/Urban1k/annotations/annotations.json"),
                    lambda d: [a["caption"] for a in d["annotations"]]),
        "flickr30k_val": (os.path.join(REPO, "datasets/flickr30k-images/flickr30k_val.json"),
                          lambda d: [c for row in d for c in row["caption"]]),
    }
    for name, (path, extract) in suites.items():
        if not os.path.exists(path):
            continue
        with open(path) as f:
            caps = extract(json.load(f))[: args.num_samples * 5]
        _measure(tok, name, caps, args.buckets)

    # the merged distribution the recipes train on: the diverse sampler's
    # merges over per-image caption pools, which sizes --text-ctx
    coco_path = suites["coco_val2017"][0]
    if os.path.exists(coco_path):
        with open(coco_path) as f:
            ann = json.load(f)
        per_img = collections.defaultdict(list)
        for a in ann["annotations"]:
            per_img[a["image_id"]].append(a["caption"])
        pool_list = [v for v in per_img.values() if len(v) >= 3][: args.num_samples * 2]
        mrng = random.Random(0)
        merged = [c for pool in pool_list
                  for c in sample_diverse_captions(pool, k=2, max_merged_num=args.max_merged_num,
                                                   rng=mrng)]
        n = args.max_merged_num
        _measure(tok, f"coco merged sampler (max_merged={n})", merged, args.buckets,
                 f"coco merged sampler (max_merged={n}, BPE-estimated: no merges asset)")

    if args.train_data:
        rng = random.Random(0)
        caps = []
        urls, _ = expand_urls(args.train_data)
        for url in urls:
            with tarfile.open(url) as tf:
                for m in tf:
                    if not m.name.endswith(".json"):
                        continue
                    meta = json.loads(tf.extractfile(m).read())
                    # caption 0 of the k sampled is what the step consumes
                    caps.append(sample_diverse_captions(
                        collect_captions(meta), k=1, max_merged_num=args.max_merged_num,
                        rng=rng)[0])
                    if len(caps) >= args.num_samples:
                        break
            if len(caps) >= args.num_samples:
                break
        _measure(tok, "train_feed", caps, args.buckets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
