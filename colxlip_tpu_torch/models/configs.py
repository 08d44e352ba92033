"""Model configuration dataclasses and the JSON architecture registry.

Port of ``colxlip_tpu/models/configs.py`` without its ``PrecisionPolicy``
(which imports ``jax.numpy``): the port passes the compute dtype as a
``torch.dtype`` to ``factory.create_model`` instead.

The registry reads ``colxlip_tpu/model_configs/*.json`` as data, by file
path — the JSON files are shared with the JAX package, never copied.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import pathlib
import re
from typing import Optional, Tuple, Union

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CLIPVisionCfg:
    """Vision tower config (colxlip_tpu/models/configs.py CLIPVisionCfg)."""
    layers: int = 12
    width: int = 768
    head_width: int = 64
    mlp_ratio: float = 4.0
    patch_size: int = 16
    image_size: Union[int, Tuple[int, int]] = 224
    ls_init_value: Optional[float] = None
    patch_dropout: float = 0.0
    attentional_pool: bool = False
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    no_ln_pre: bool = False
    pos_embed_type: str = "learnable"
    final_ln_after_pool: bool = False
    pool_type: str = "tok"
    output_tokens: bool = False
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> Tuple[int, int]:
        h, w = _to_2tuple(self.image_size)
        return h // self.patch_size, w // self.patch_size

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw


@dataclasses.dataclass
class CLIPTextCfg:
    """Text tower config (colxlip_tpu/models/configs.py CLIPTextCfg)."""
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    embed_cls: bool = False
    pad_id: int = 0
    no_causal_mask: bool = False
    pool_type: str = "argmax"
    proj_type: str = "linear"
    proj_bias: bool = False
    output_tokens: bool = False


@dataclasses.dataclass
class CLIPCfg:
    """Full model config = one JSON file in model_configs/."""
    embed_dim: int = 512
    vision_cfg: CLIPVisionCfg = dataclasses.field(default_factory=CLIPVisionCfg)
    text_cfg: CLIPTextCfg = dataclasses.field(default_factory=CLIPTextCfg)
    quick_gelu: bool = False
    gelu_approximate: bool = False
    init_logit_scale: float = 2.6592600345530126
    init_logit_bias: Optional[float] = None
    alpha: float = 0.5

    @classmethod
    def from_dict(cls, d: dict) -> "CLIPCfg":
        d = copy.deepcopy(d)
        vision = d.pop("vision_cfg", {})
        text = d.pop("text_cfg", {})
        known_v = {f.name for f in dataclasses.fields(CLIPVisionCfg)}
        known_t = {f.name for f in dataclasses.fields(CLIPTextCfg)}
        known_c = {f.name for f in dataclasses.fields(cls)} | {"multimodal_cfg"}
        # unknown keys are tolerated but warned about: a typo'd field would
        # otherwise build a default-valued architecture with no diagnostic
        dropped = ([k for k in vision if k not in known_v]
                   + [k for k in text if k not in known_t]
                   + [k for k in d if k not in known_c])
        if dropped:
            logger.warning("model config: ignoring unknown keys %s", dropped)
        return cls(
            vision_cfg=CLIPVisionCfg(
                **{k: v for k, v in vision.items() if k in known_v}),
            text_cfg=CLIPTextCfg(
                **{k: v for k, v in text.items() if k in known_t}),
            **{k: v for k, v in d.items()
               if k in known_c and k != "multimodal_cfg"},
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _to_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


# ---------------------------------------------------------------------------
# JSON architecture registry (read from the JAX package's model_configs/)
# ---------------------------------------------------------------------------

MODEL_CONFIG_DIR = (pathlib.Path(__file__).resolve().parents[2]
                    / "colxlip_tpu" / "model_configs")


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def _is_model_config(cfg: dict) -> bool:
    return "embed_dim" in cfg and "vision_cfg" in cfg and "text_cfg" in cfg


def _scan(directory: pathlib.Path) -> dict:
    found = {}
    if directory.is_dir():
        for p in directory.glob("*.json"):
            with open(p) as f:
                cfg = json.load(f)
            if _is_model_config(cfg):
                found[p.stem] = cfg
    return {k: found[k] for k in sorted(found, key=_natural_key)}


_MODEL_CONFIGS: dict = _scan(MODEL_CONFIG_DIR)


def list_models():
    """Registered architecture names, natural-sorted."""
    return list(_MODEL_CONFIGS.keys())


def add_model_config(path) -> None:
    """Register one JSON model config file (same schema gate as the scan)."""
    p = pathlib.Path(path)
    with open(p) as f:
        cfg = json.load(f)
    if not _is_model_config(cfg):
        raise ValueError(
            f"{p}: not a model config (needs embed_dim/vision_cfg/text_cfg)")
    _MODEL_CONFIGS[p.stem] = cfg


def get_model_config(model_name: str) -> Optional[dict]:
    if model_name in _MODEL_CONFIGS:
        return copy.deepcopy(_MODEL_CONFIGS[model_name])
    return None
