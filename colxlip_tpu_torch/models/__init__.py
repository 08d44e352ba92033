"""Model definitions: port of ``colxlip_tpu/models``."""
from .clip import CLIP, ColXLIP, l2_normalize
from .configs import (
    CLIPCfg,
    CLIPTextCfg,
    CLIPVisionCfg,
    add_model_config,
    get_model_config,
    list_models,
)

__all__ = [
    "CLIP", "CLIPCfg", "CLIPTextCfg", "CLIPVisionCfg", "ColXLIP",
    "add_model_config", "get_model_config", "l2_normalize", "list_models",
]
