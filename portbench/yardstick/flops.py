"""Model FLOPs of one ColXLIP colclip train step, as ``mfu`` counts them.

Each tower's matrix products at 6 x parameters x tokens (2 forward, 4
backward): the blocks over all their tokens, the patch embedding over the
patches, the token head's Linear over the tokens it projects, the pooled
projection over one token. Attention at 4 N^2 D forward and 8 N^2 D backward
a block (the whole N x N square, causal or not). The colclip MaxSim at
2 b^2 Lt Li D forward and twice that backward, and the global logits at
6 b^2 E. No recomputation is counted: a kernel that recomputes a product
does more work than the model needs, and ``mfu`` does not credit it.
"""
from __future__ import annotations

import dataclasses

HEAD_WIDTH = 64      # OpenCLIP's vision head width where a config names none
MLP_RATIO = 4


@dataclasses.dataclass(frozen=True)
class Geometry:
    embed_dim: int
    image_size: int
    patch_size: int
    v_width: int
    v_layers: int
    v_head_width: int
    t_ctx: int
    t_width: int
    t_layers: int
    t_heads: int
    vocab_size: int

    @classmethod
    def from_model(cls, model: dict) -> "Geometry":
        """``model``: the OpenCLIP-style dict (embed_dim, vision_cfg, text_cfg)."""
        v, t = model["vision_cfg"], model["text_cfg"]
        return cls(embed_dim=model["embed_dim"], image_size=v["image_size"],
                   patch_size=v["patch_size"], v_width=v["width"], v_layers=v["layers"],
                   v_head_width=v.get("head_width", HEAD_WIDTH), t_ctx=t["context_length"],
                   t_width=t["width"], t_layers=t["layers"], t_heads=t["heads"],
                   vocab_size=t["vocab_size"])

    @property
    def patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def v_tokens(self) -> int:
        return self.patches + 1

    @property
    def v_heads(self) -> int:
        return self.v_width // self.v_head_width

    @property
    def v_head_dim(self) -> int:
        return self.v_head_width

    @property
    def t_head_dim(self) -> int:
        return self.t_width // self.t_heads

    @property
    def v_mlp(self) -> int:
        return MLP_RATIO * self.v_width

    @property
    def t_mlp(self) -> int:
        return MLP_RATIO * self.t_width


def block_params(width: int) -> int:
    """Matrix parameters of one residual block: in_proj 3 W^2, out_proj W^2,
    c_fc and c_proj 4 W^2 each."""
    return 12 * width * width


def vision_flops(g: Geometry) -> float:
    """Forward + backward FLOPs of the vision tower and its token head, one image."""
    blocks = 6 * g.v_layers * block_params(g.v_width) * g.v_tokens
    attention = g.v_layers * 12 * g.v_tokens ** 2 * g.v_width
    patch = 6 * (3 * g.patch_size ** 2) * g.v_width * g.patches
    head = 6 * g.v_width * g.embed_dim * g.patches
    proj = 6 * g.v_width * g.embed_dim
    return blocks + attention + patch + head + proj


def text_flops(g: Geometry) -> float:
    """Forward + backward FLOPs of the text tower and its token head, one caption."""
    blocks = 6 * g.t_layers * block_params(g.t_width) * g.t_ctx
    attention = g.t_layers * 12 * g.t_ctx ** 2 * g.t_width
    head = 6 * g.t_width * g.embed_dim * g.t_ctx
    proj = 6 * g.t_width * g.embed_dim
    return blocks + attention + head + proj


def loss_flops(g: Geometry, batch: int) -> float:
    """Forward + backward FLOPs of the colclip loss a step: MaxSim and the
    global logits."""
    maxsim = 3 * 2 * batch * batch * g.t_ctx * g.patches * g.embed_dim
    logits = 3 * 2 * batch * batch * g.embed_dim
    return maxsim + logits


def train_step_flops(g: Geometry, batch: int) -> float:
    return batch * (vision_flops(g) + text_flops(g)) + loss_flops(g, batch)
