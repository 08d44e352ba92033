"""Caption sentence-splitting and diverse sampling/merging augmentation.

The port's own copy of ``colxlip_tpu/data/captions.py``, kept line for line
(the retrieval readers' captions must equal the JAX package's, and the port
imports nothing of it). Counterpart of reference src/colxlip/data.py:24-65,146-182:
  - ``split_caption``: split on newline / '</s>' / '.' (data.py:24-26)
  - ``sample_diverse_captions``: the 'diverse_sampling' mode of ``sample_dict``
    (data.py:146-182): draw k captions; for each draw, pick merged_num ~
    U{1..max_merged_num}; merged_num==1 -> a single random caption; otherwise
    50% merge a random *contiguous* run of merged_num captions, 50% merge
    merged_num captions sampled from random positions, joined with '. '.

The reference's caption-field layout for recaptioned shards (raw_caption +
{short,long}{IB,SV,LLA}_captions, data.py:152-154) is preserved, plus the
pixelprose single-field mode.
"""
from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Sequence

CAPTION_KEYS = (
    "raw_caption",
    "shortIB_captions",
    "longIB_captions",
    "shortSV_captions",
    "longSV_captions",
    "shortLLA_captions",
    "longLLA_captions",
)


def split_caption(text: str) -> List[str]:
    """Split a caption into sentences (reference data.py:24-26)."""
    return [cap.strip() for cap in re.split(r"\n|</s>|[.]", text) if cap.strip()]


def _merge_contiguous(captions: Sequence[str], merged_num: int, rng: random.Random) -> str:
    """'. '-join a random contiguous run (reference data.py:28-44)."""
    n = len(captions)
    if merged_num >= n:
        return ". ".join(captions)
    start = rng.randrange(0, n - merged_num)
    return ". ".join(captions[start : start + merged_num])


def collect_captions(
    meta: Dict, *, pixelprose: bool = False, keys: Sequence[str] = CAPTION_KEYS
) -> List[str]:
    """Flatten a sample's caption fields into one candidate list (data.py:149-154)."""
    if pixelprose:
        return split_caption(meta["caption"])
    captions: List[str] = []
    for key in keys:
        v = meta.get(key)
        if v is None:
            continue
        captions.extend(v if isinstance(v, list) else [v])
    return captions


def sample_diverse_captions(
    captions_list: Sequence[str],
    k: int = 3,
    max_merged_num: int = 3,
    rng: Optional[random.Random] = None,
) -> List[str]:
    """Draw k (possibly merged) captions (reference data.py:155-178)."""
    rng = rng or random
    n = len(captions_list)
    if n == 0:
        return [""] * k
    if not isinstance(captions_list, list):
        captions_list = list(captions_list)
    out: List[str] = []
    for _ in range(k):
        merged_num = rng.randint(1, max_merged_num)
        if merged_num == 1:
            out.append(rng.choice(captions_list))
        elif rng.random() < 0.5:
            out.append(_merge_contiguous(captions_list, merged_num, rng))
        else:
            if n >= merged_num:
                chosen = rng.sample(captions_list, merged_num)
            else:
                chosen = [rng.choice(captions_list) for _ in range(merged_num)]
            out.append(". ".join(chosen))
    return out


def sample_and_tokenize(
    meta: Dict,
    tokenizer,
    k: int = 3,
    max_merged_num: int = 3,
    pixelprose: bool = False,
    rng: Optional[random.Random] = None,
):
    """``sample_dict`` equivalent (data.py:146-182): returns [k, ctx] int32."""
    captions = collect_captions(meta, pixelprose=pixelprose)
    sampled = sample_diverse_captions(captions, k=k, max_merged_num=max_merged_num, rng=rng)
    return tokenizer(sampled)
