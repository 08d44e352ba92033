"""ColXLIP in plain PyTorch, fp32, TF32 off: the towers, the token heads, the
colclip loss and AdamW, from their published definitions (OpenCLIP's
``VisionTransformer`` and ``TextTransformer``; ColXLIP's LN -> Linear -> GELU
-> LN token heads on the patch tokens and on the text tokens before EOT,
those at and after EOT zeroed first; the 'nonzero' MaxSim mean).

It takes the parameters as a dict under OpenCLIP's state-dict names and the
inputs as tensors, and computes in blocks of rows so that it fits beside
nothing else on the card: a train step takes every row's features without
gradients, the loss and its gradient with respect to those features, then
each block of rows again with gradients, fed the features' gradients. That
is the same gradient, computed in fp32 in another order.

Every product takes its operands through ``q``: ``exact`` (the identity)
for the reference, ``fp8`` for the benchmark's control, which rounds each
operand to float8 e4m3 under a per-tensor scale (its largest magnitude to
448, e4m3's largest finite value) and passes the gradient straight through,
so the backward's products take the rounded operands and unrounded
gradients: the reference computed in the precision below the
configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..yardstick.flops import Geometry

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]
FP8_MAX = 448.0
MAXSIM_EPS = 1e-8
MAX_LOGIT_SCALE = math.log(100.0)


def exact_fp32() -> None:
    """fp32 products stay fp32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in fp32, with
    a straight-through gradient."""
    d = x.detach()
    scale = d.abs().amax().clamp_min(1e-30) / FP8_MAX
    rounded = (d / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (rounded - d)


def _linear(x, p: Params, name: str, q: Quant):
    return q(x) @ q(p[name + ".weight"]).T + p[name + ".bias"]


def _ln(x, p: Params, name: str):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], 1e-5)


def _attention(x, p: Params, pre: str, heads: int, causal: bool, q: Quant):
    b, n, w = x.shape
    qkv = q(x) @ q(p[pre + "in_proj_weight"]).T + p[pre + "in_proj_bias"]
    qh, kh, vh = (t.reshape(b, n, heads, w // heads).transpose(1, 2) for t in qkv.chunk(3, -1))
    s = (q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(w // heads)
    if causal:
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
    o = (q(s.softmax(-1)) @ q(vh)).transpose(1, 2).reshape(b, n, w)
    return _linear(o, p, pre + "out_proj", q)


def _blocks(x, p: Params, prefix: str, layers: int, heads: int, causal: bool, q: Quant):
    for i in range(layers):
        pre = f"{prefix}.resblocks.{i}."
        x = x + _attention(_ln(x, p, pre + "ln_1"), p, pre + "attn.", heads, causal, q)
        h = F.gelu(_linear(_ln(x, p, pre + "ln_2"), p, pre + "mlp.c_fc", q))
        x = x + _linear(h, p, pre + "mlp.c_proj", q)
    return x


def _token_head(x, p: Params, prefix: str, q: Quant):
    x = _linear(_ln(x, p, prefix + ".0"), p, prefix + ".1", q)
    return _ln(F.gelu(x), p, prefix + ".3")


def encode_image(p: Params, g: Geometry, images: torch.Tensor, q: Quant = exact):
    """NHWC float images [B, H, W, 3] -> (unit pooled [B, E], unit patch
    tokens [B, P, E])."""
    x = F.conv2d(q(images.permute(0, 3, 1, 2)), q(p["visual.conv1.weight"]),
                 stride=g.patch_size)
    x = x.flatten(2).transpose(1, 2)
    cls = p["visual.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + p["visual.positional_embedding"]
    x = _ln(x, p, "visual.ln_pre")
    x = _blocks(x, p, "visual.transformer", g.v_layers, g.v_heads, False, q)
    x = _ln(x, p, "visual.ln_post")
    pooled = q(x[:, 0]) @ q(p["visual.proj"])
    tokens = _token_head(x[:, 1:], p, "vision_token_layer", q)
    return F.normalize(pooled, dim=-1), F.normalize(tokens, dim=-1)


def encode_text(p: Params, g: Geometry, texts: torch.Tensor, q: Quant = exact):
    """Token ids [B, n] (EOT the largest id of each row) -> (unit pooled
    [B, E], unit tokens [B, n, E])."""
    n = texts.shape[1]
    x = p["token_embedding.weight"][texts] + p["positional_embedding"][:n]
    x = _blocks(x, p, "transformer", g.t_layers, g.t_heads, True, q)
    x = _ln(x, p, "ln_final")
    eot = texts.argmax(dim=-1)
    pooled = q(x[torch.arange(x.shape[0], device=x.device), eot]) @ q(p["text_projection"])
    keep = torch.arange(n, device=x.device)[None, :] < eot[:, None]
    tokens = _token_head(x * keep[:, :, None], p, "text_token_layer", q)
    return F.normalize(pooled, dim=-1), F.normalize(tokens, dim=-1)


def maxsim_nonzero(text: torch.Tensor, image: torch.Tensor, q: Quant = exact,
                   block: int = 16) -> torch.Tensor:
    """[M, Lt, E] x [K, Li, E] -> [M, K]: for each text token its best image
    token, averaged over the text tokens whose best is not exactly 0."""
    rows, text, image = [], q(text), q(image)
    for i in range(0, text.shape[0], block):
        sim = torch.einsum("mte,kie->mkti", text[i:i + block], image)
        best = sim.max(dim=-1).values
        w = (best != 0).float()
        rows.append((best * w).sum(-1) / (w.sum(-1) + MAXSIM_EPS))
    return torch.cat(rows)


def colclip_loss(img, txt, tok_img, tok_txt, logit_scale_param, alpha: float,
                 q: Quant = exact) -> Dict[str, torch.Tensor]:
    scale = logit_scale_param.exp()
    labels = torch.arange(img.shape[0], device=img.device)
    logits = scale * (q(img) @ q(txt).T)
    glob = (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2
    tok = scale * maxsim_nonzero(tok_txt, tok_img, q)
    token = (F.cross_entropy(tok, labels) + F.cross_entropy(tok.T, labels)) / 2
    return {"global_contrastive_loss": glob, "token_contrastive_loss": token,
            "total_loss": alpha * glob + (1 - alpha) * token}


def encode_blocks(p: Params, g: Geometry, images, texts, block: int, q: Quant = exact):
    """Both towers over all rows, ``block`` rows at a time, no gradients."""
    with torch.no_grad():
        ims = [encode_image(p, g, images[i:i + block], q)
               for i in range(0, images.shape[0], block)]
        txs = [encode_text(p, g, texts[i:i + block], q)
               for i in range(0, texts.shape[0], block)]
    return (torch.cat([a for a, _ in ims]), torch.cat([b for _, b in ims]),
            torch.cat([a for a, _ in txs]), torch.cat([b for _, b in txs]))


def no_decay(name: str, t: torch.Tensor) -> bool:
    """OpenCLIP's exclusion from weight decay: gains, biases, logit_scale."""
    return t.ndim < 2 or "bn" in name or "ln" in name or "bias" in name or "logit_scale" in name


def cosine_lr(base_lr: float, warmup: int, steps: int, step: int) -> float:
    """Linear warmup to ``base_lr`` ((step + 1) / warmup), then cosine to 0."""
    if step < warmup:
        return base_lr * (step + 1) / warmup
    e, es = step - warmup, max(steps - warmup, 1)
    return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr


class TrainReference:
    """colclip steps with AdamW (decoupled weight decay, bias-corrected
    moments, eps outside the square root) on ``params`` (fp32, updated in
    place). ``hp``: alpha, lr, warmup, total_steps, beta1, beta2, eps, wd.
    ``q``: the products' operands, ``exact`` or ``fp8``. ``features``: the
    last step's (pooled image, image tokens, pooled text, text tokens)."""

    def __init__(self, g: Geometry, params: Params, hp: dict, block: int, q: Quant = exact):
        self.g, self.hp, self.block, self.q = g, hp, block, q
        self.p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0

    def loss_and_grads(self, images, texts) -> Tuple[Dict[str, float], Params]:
        g, b, p, q = self.g, self.block, self.p, self.q
        for t in p.values():
            t.grad = None
        feats = [f.requires_grad_(True) for f in encode_blocks(p, g, images, texts, b, q)]
        img, tok_img, txt, tok_txt = feats
        self.features = tuple(f.detach() for f in feats)
        losses = colclip_loss(img, txt, tok_img, tok_txt, p["logit_scale"], self.hp["alpha"], q)
        losses["total_loss"].backward()
        d_img, d_tok_img, d_txt, d_tok_txt = (f.grad for f in feats)
        for i in range(0, images.shape[0], b):
            out = encode_image(p, g, images[i:i + b], q)
            torch.autograd.backward(out, (d_img[i:i + b], d_tok_img[i:i + b]))
        for i in range(0, texts.shape[0], b):
            out = encode_text(p, g, texts[i:i + b], q)
            torch.autograd.backward(out, (d_txt[i:i + b], d_tok_txt[i:i + b]))
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t)).detach()
                 for k, t in p.items()}
        return {k: float(v.detach()) for k, v in losses.items()}, grads

    @torch.no_grad()
    def update(self, grads: Params) -> None:
        hp = self.hp
        lr = cosine_lr(hp["lr"], hp["warmup"], hp["total_steps"], self.t)
        self.t += 1
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["eps"]
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, t in self.p.items():
            gk = grads[k]
            self.m[k].mul_(b1).add_(gk, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
            if not no_decay(k, t):
                t.mul_(1 - lr * hp["wd"])
            t.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + eps))
        self.p["logit_scale"].clamp_(0.0, MAX_LOGIT_SCALE)

    def step(self, images, texts) -> Tuple[Dict[str, float], Params]:
        losses, grads = self.loss_and_grads(images, texts)
        self.update(grads)
        return losses, grads


def encode_reference(p: Params, g: Geometry, kind: str, items: torch.Tensor, block: int,
                     q: Quant = exact) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, tokens) of one tower over ``items``, ``block`` rows at a time."""
    fn = encode_image if kind == "image" else encode_text
    with torch.no_grad():
        outs = [fn(p, g, items[i:i + block], q) for i in range(0, items.shape[0], block)]
    return torch.cat([a for a, _ in outs]), torch.cat([b for _, b in outs])


def leaf_norms(tensors: Params, names: Sequence[str]) -> List[float]:
    """fp32 norm of each named tensor, in ``names`` order, one copy to the host."""
    return torch.stack([tensors[k].float().norm() for k in names]).tolist()
