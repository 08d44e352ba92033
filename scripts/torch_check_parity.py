#!/usr/bin/env python3
"""Golden-parity check of the PyTorch port: compare a results.jsonl eval run
against expected R@K. The twin of ``scripts/check_parity.py``.

Run ``CKPT=<ref.pt> scripts/torch_inference.sh``, then

    python3 scripts/torch_check_parity.py logs/<run>/checkpoints/results.jsonl \\
        datasets/golden/<name>.expected.json

The expected-results schema is ``check_parity.py``'s:
{"checkpoint", "source", "tolerance", "requires_clip_bpe", "metrics":
{"<suite>_<direction>_<R@K|...>": value}}. Goldens with
``requires_clip_bpe: true`` need the CLIP BPE merges asset, checked through
the port's tokenizer.

Exit code 0 = all metrics within tolerance; 1 = any miss (each printed);
2 = unrecorded goldens or a required BPE asset missing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _check_tokenizer_asset(required: bool) -> bool:
    """Text-side parity against a real reference checkpoint needs the CLIP
    BPE merges asset: without it the tokenizer falls back to zero merges and
    recall is not comparable. Returns True when the check may proceed."""
    from colxlip_tpu_torch.data.tokenizer import SimpleTokenizer

    if SimpleTokenizer().has_merges:
        return True
    print("=" * 72, file=sys.stderr)
    print(("ERROR" if required else "WARNING") +
          ": CLIP BPE merges asset NOT found — tokenizer is in the\nzero-merges "
          "fallback. Parity vs a real reference checkpoint is NOT\nmeaningful until "
          "you fetch it: python scripts/fetch_assets.py", file=sys.stderr)
    print("=" * 72, file=sys.stderr)
    return not required


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("results_jsonl", help="results.jsonl written by the eval")
    p.add_argument("expected_json", help="expected-results file (schema above)")
    p.add_argument("--line", type=int, default=-1,
                   help="which results.jsonl line to check (default: last)")
    p.add_argument("--tolerance", type=float, default=None,
                   help="override the file's tolerance")
    p.add_argument("--allow-degraded-tokenizer", action="store_true",
                   help="check anyway when the golden requires the CLIP BPE "
                        "asset but it is absent (numbers will NOT match)")
    args = p.parse_args(argv)

    with open(args.expected_json) as f:
        expected = json.load(f)
    if expected.get("metrics") is None:
        print(f"{args.expected_json}: goldens are UNRECORDED — run step 2 of "
              "docs/PARITY_RUNBOOK.md to produce them from the reference, "
              "then fill 'metrics'.", file=sys.stderr)
        return 2
    required = bool(expected.get("requires_clip_bpe")) and not args.allow_degraded_tokenizer
    if not _check_tokenizer_asset(required):
        return 2

    with open(args.results_jsonl) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    if not lines:
        print("results.jsonl is empty", file=sys.stderr)
        return 1
    got = lines[args.line]
    tol = args.tolerance if args.tolerance is not None else expected.get("tolerance", 0.005)

    misses, hits = [], 0
    for key, want in expected["metrics"].items():
        if key not in got:
            misses.append(f"MISSING  {key} (expected {want})")
        elif abs(got[key] - want) > tol:
            misses.append(f"MISMATCH {key}: got {got[key]:.4f}, "
                          f"expected {want:.4f} (tol {tol})")
        else:
            hits += 1
    print(f"parity: {hits}/{len(expected['metrics'])} metrics within "
          f"±{tol} of '{expected.get('checkpoint', '?')}'")
    for m in misses:
        print("  " + m)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
