"""Caption generation for CoCa: port of ``colxlip_tpu/serving/generate.py``.

``generate_captions(model, images)`` decodes token ids [B, context_length]:
SOT, then one token a step up to ``max_len``, each chosen from the logits of
the previous position; after a row's EOT every token is pad (0). As in the
JAX loop, the image conditioning (``CoCa.embed_images``) is computed once,
and every step runs the text tower and the decoder again on the whole fixed
[B, context] buffer (pads after the cursor): causality keeps the cursor's
logits independent of the pad tail, so the fixed buffer is exact. Row t - 1
of the decoder predicts token t.

Methods: 'greedy' (argmax), 'top_k' (a draw from the softmax of the top_k
logits over ``temperature``) and 'top_p' (nucleus sampling inside the top_k:
the smallest prefix whose probability reaches ``top_p``, the first token
always kept). The draws come from a ``torch.Generator`` seeded with
``seed`` on the model's device, so a seed repeats its tokens; they cannot
follow the JAX PRNG's stream.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

SOT = 49406
EOT = 49407
METHODS = ("greedy", "top_k", "top_p")


def _next_token(logits: torch.Tensor, method: str, top_k: int, top_p: float,
                temperature: float, generator: torch.Generator) -> torch.Tensor:
    if method == "greedy":
        return logits.argmax(dim=-1)
    t = torch.full((), temperature, dtype=logits.dtype, device=logits.device)
    vals, idx = torch.topk(logits / t, top_k, dim=-1)
    if method == "top_p":
        probs = torch.softmax(vals, dim=-1)
        keep = probs.cumsum(dim=-1) - probs < top_p
        vals = vals.masked_fill(~keep, float("-inf"))
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=generator)
    return idx.gather(1, choice)[:, 0]


@torch.inference_mode()
def generate_captions(model, images, *, max_len: Optional[int] = None,
                      method: str = "greedy", top_k: int = 50, top_p: float = 0.9,
                      temperature: float = 1.0, seed: int = 0) -> np.ndarray:
    """images [B, H, W, 3] (numpy or a tensor) -> token ids [B,
    context_length] int32 (SOT ... EOT 0 ...), on the model's device."""
    if method not in METHODS:
        raise ValueError(f"unknown decode method: {method!r}")
    device = model.logit_scale.device
    ctx = model.cfg.text_cfg.context_length
    max_len = ctx if max_len is None else min(max_len, ctx)
    images = torch.as_tensor(images).to(device)
    image_embs = model.embed_images(images)
    b = images.shape[0]
    tokens = torch.zeros((b, ctx), dtype=torch.long, device=device)
    tokens[:, 0] = SOT
    done = torch.zeros(b, dtype=torch.bool, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    for t in range(1, max_len):
        hidden = model.text_decoder(model.encode_text(tokens)[1][:, :-1], image_embs)
        logits = model.vocab_logits(hidden[:, t - 1]).float()
        nxt = _next_token(logits, method, top_k, top_p, temperature, generator)
        nxt = nxt.masked_fill(done, 0)
        tokens[:, t] = nxt
        done |= nxt == EOT
    return tokens.cpu().numpy().astype(np.int32)


def tokens_to_text(tokens, tokenizer) -> List[str]:
    """Strip SOT, EOT and pad and decode each row with the BPE tokenizer."""
    return [tokenizer.decode([int(t) for t in row if int(t) not in (SOT, EOT, 0)]).strip()
            for row in np.asarray(tokens)]
