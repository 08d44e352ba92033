"""Streaming vocabulary cross-entropy for the CoCa caption head: port of
``colxlip_tpu/ops/vocab_ce.py``.

The masked-mean CE of ``hidden @ kernel`` against ``labels`` (positions
labelled ``ignore_index`` count in neither the sum nor the count), without
ever holding the [B, L, V] logits: the B L rows are flattened, padded with
``ignore_index`` rows to a multiple of the chunk, and taken ``chunk`` (1024)
rows at a time.

- forward: a chunk's logits ``h_c @ W`` in fp32, their logsumexp minus the
  true logit, masked and summed into one fp32 scalar; the mean divides by
  the count of valid labels (at least 1).
- backward: each chunk's softmax is recomputed, the one-hot subtracted and
  the rows scaled by ``g / count`` (zero where the label is ignored); dh of
  the chunk is ``dl @ W^T``, returned in the activation dtype, and dW adds
  ``h_c^T @ dl`` into one fp32 [D, V] buffer across the chunks.

As in the JAX custom VJP the kernel is cast to the activation dtype before
every product (so the backward's softmax is the derivative of this very
loss), the products sum in fp32 (a bf16 operand is widened first, which
keeps its products exact), and the backward casts ``dl`` to the activation
dtype before its two products. A plain-PyTorch custom autograd function: the
JAX module is XLA code, not a Pallas kernel, so its products stay
``torch.matmul`` on either device.
"""
from __future__ import annotations

import torch


def _pick_chunk(rows: int, target: int = 1024) -> int:
    """The largest divisor of ``rows`` that is at most ``target``."""
    c = min(target, rows)
    while rows % c:
        c -= 1
    return c


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed and returned in fp32 (the JAX dot with
    preferred_element_type=float32)."""
    return torch.matmul(a.float(), b.float())


def _flatten_pad(hidden: torch.Tensor, labels: torch.Tensor, ignore_index: int, chunk: int):
    """[B, L, D], [B, L] -> ([n, c, D], [n, c]) padded with ignored rows."""
    d = hidden.shape[-1]
    h2, lab = hidden.reshape(-1, d), labels.reshape(-1)
    pad = (-h2.shape[0]) % chunk
    if pad:
        h2 = torch.cat([h2, h2.new_zeros((pad, d))])
        lab = torch.cat([lab, lab.new_full((pad,), ignore_index)])
    c = _pick_chunk(h2.shape[0], chunk)
    return h2.reshape(-1, c, d), lab.reshape(-1, c)


class _StreamingVocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, kernel, labels, ignore_index, chunk):
        hs, labs = _flatten_pad(hidden, labels, ignore_index, chunk)
        k_cast = kernel.to(hidden.dtype)
        count = (labs != ignore_index).sum().float().clamp_min(1.0)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for h_c, lab_c in zip(hs, labs):
            logits = _mm32(h_c, k_cast)
            true = logits.gather(1, lab_c.clamp_min(0)[:, None])[:, 0]
            valid = (lab_c != ignore_index).float()
            total = total + ((torch.logsumexp(logits, dim=-1) - true) * valid).sum()
        ctx.save_for_backward(hidden, kernel, labels, count)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        return total / count

    @staticmethod
    def backward(ctx, g):
        hidden, kernel, labels, count = ctx.saved_tensors
        hs, labs = _flatten_pad(hidden, labels, ctx.ignore_index, ctx.chunk)
        k_cast = kernel.to(hidden.dtype)
        row_scale = g.float() / count
        dw = torch.zeros(kernel.shape, dtype=torch.float32, device=kernel.device)
        dh = []
        for h_c, lab_c in zip(hs, labs):
            dl = torch.softmax(_mm32(h_c, k_cast), dim=-1)
            rows = torch.arange(dl.shape[0], device=dl.device)
            dl[rows, lab_c.clamp_min(0)] -= 1.0
            valid = (lab_c != ctx.ignore_index).float()
            dl_cast = (dl * (valid * row_scale)[:, None]).to(hidden.dtype)
            dh.append(_mm32(dl_cast, k_cast.t()).to(hidden.dtype))
            dw += _mm32(h_c.t(), dl_cast)
        r = hidden.shape[0] * hidden.shape[1]
        dh = torch.cat(dh)[:r].reshape(hidden.shape)
        return dh, dw.to(kernel.dtype), None, None, None


def streaming_vocab_ce(hidden: torch.Tensor, kernel: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Masked-mean CE of ``hidden @ kernel`` against ``labels``: hidden [B, L,
    D] (any float dtype), kernel [D, V], labels [B, L] integer; an fp32
    scalar. Never holds the [B, L, V] logits."""
    return _StreamingVocabCE.apply(hidden, kernel, labels, ignore_index, chunk)
