"""Model factory: port of ``colxlip_tpu/factory.py``.

``create_model(name, device, dtype)`` builds ``CoCa`` when "coca" is in the
name (with the config's ``multimodal_cfg``), ``ColXLIP`` when "colxlip" is,
else ``CLIP``, with ``dtype`` compute (the JAX service's bf16 policy by
default) and fp32 parameters (bf16 Dense, attention, embedding and patchify
weights under ``param_dtype=bfloat16``, the 'pure_bf16' policy),
initialised from a seeded ``torch.Generator`` on the CPU (the same weights
whatever the device), then moved to ``device``. ``create_teacher`` builds a
distillation teacher the same way and loads its ``.pt``.
``create_model_and_transforms``, ``get_tokenizer`` and ``create_loss`` are
what the training entry point (``main.py``) builds from its flags.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .convert import load_pt_state_dict
from .data.tokenizer import SimpleTokenizer
from .data.transforms import AugmentationCfg, ImageTransform, image_transform
from .models import CLIP, CLIPCfg, ColXLIP, get_model_config, list_models
from .models.coca import CoCa, CrossAttention
from .models.configs import MultimodalCfg, multimodal_config
from .models.layers import AttentionalPooler, Linear, MultiHeadAttention
from .models.pos_embed import get_2d_sincos_pos_embed, interpolate_pos_embed
from .models.vision import PatchEmbed
from .pretrained import QUICK_GELU_TAGS, resolve_pretrained

logger = logging.getLogger(__name__)


# precision -> (parameter dtype, compute dtype): the JAX PrecisionPolicy
PRECISION_DTYPES = {"fp32": (torch.float32, torch.float32),
                    "amp": (torch.float32, torch.float32),
                    "bf16": (torch.float32, torch.bfloat16),
                    "amp_bf16": (torch.float32, torch.bfloat16),
                    "pure_bf16": (torch.bfloat16, torch.bfloat16)}


def _policy(precision: str) -> Tuple[torch.dtype, torch.dtype]:
    if precision not in PRECISION_DTYPES:
        raise ValueError(f"unsupported precision: {precision!r}")
    return PRECISION_DTYPES[precision]


def compute_dtype(precision: str) -> torch.dtype:
    """The JAX ``PrecisionPolicy``'s compute dtype: 'fp32' / 'amp' compute in
    fp32, 'bf16' / 'amp_bf16' / 'pure_bf16' in bf16."""
    return _policy(precision)[1]


def param_dtype(precision: str) -> torch.dtype:
    """The policy's parameter dtype: bf16 under 'pure_bf16', else fp32."""
    return _policy(precision)[0]


@torch.no_grad()
def cast_params_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the parameters that the JAX model creates in the policy's
    ``param_dtype`` (every Dense kernel and bias, the attention projections,
    the token embedding, the patchify kernel and CoCa's vocab head) to
    ``dtype``, in place. LayerNorm and LayerScale parameters, the class and
    positional embeddings, the tower projections, the pooler's queries and
    the logit scale and bias stay fp32, as the JAX model declares them."""
    tensors = []
    for mod in model.modules():
        if isinstance(mod, (Linear, nn.Embedding, PatchEmbed)):
            tensors += [mod.weight, *([mod.bias] if isinstance(mod, Linear) else [])]
        elif isinstance(mod, (MultiHeadAttention, CrossAttention)) and hasattr(
                mod, "in_proj_weight"):
            tensors += [mod.in_proj_weight, mod.in_proj_bias]
    if isinstance(model, CoCa):
        tensors.append(model.text_decoder.text_projection)
    for p in tensors:
        p.data = p.data.to(dtype)
    return model


def model_config(model_name: str, quick_gelu: Optional[bool] = None, *,
                 force_image_size: Optional[int] = None, alpha: Optional[float] = None,
                 gelu_approximate: Optional[bool] = None,
                 force_patch_dropout: Optional[float] = None,
                 image_mean: Optional[Sequence[float]] = None,
                 image_std: Optional[Sequence[float]] = None) -> CLIPCfg:
    """The registered config with the caller's overrides. ``image_mean`` /
    ``image_std`` replace the config's statistics, which both the vision
    tower's uint8 normalisation and the eval transform read, so the two
    always agree."""
    cfg_dict = get_model_config(model_name)
    if cfg_dict is None:
        raise RuntimeError(f"Model config for {model_name} not found; "
                           f"available: {list_models()}")
    cfg = CLIPCfg.from_dict(cfg_dict)
    if quick_gelu is not None:
        cfg = dataclasses.replace(cfg, quick_gelu=quick_gelu)
    if force_image_size is not None:
        cfg.vision_cfg.image_size = force_image_size
    if force_patch_dropout is not None:
        cfg.vision_cfg.patch_dropout = force_patch_dropout
    for name, stat in (("image_mean", image_mean), ("image_std", image_std)):
        if stat is not None:
            if len(stat) != 3:
                raise ValueError(f"{name} takes one value a channel (3); got {list(stat)}")
            setattr(cfg.vision_cfg, name, tuple(float(x) for x in stat))
    if alpha is not None:
        cfg = dataclasses.replace(cfg, alpha=alpha)
    if gelu_approximate is not None:
        cfg = dataclasses.replace(cfg, gelu_approximate=gelu_approximate)
    return cfg


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init at the JAX package's scales (lecun-normal dense kernels
    and zero biases; the depth-scaled block normals of the text tower and of
    CoCa's decoder; the 2-D sin-cos table where the config asks for it).
    LayerNorm and LayerScale parameters keep their constructors' constants."""
    def normal_(p: torch.Tensor, std: float) -> None:
        p.normal_(0.0, std, generator=generator)

    def scaled_blocks(blocks, width: int, layers: int) -> None:
        proj_std = width ** -0.5 * (2 * layers) ** -0.5
        for block in blocks:
            normal_(block.attn.in_proj_weight, width ** -0.5)
            normal_(block.attn.out_proj.weight, proj_std)
            normal_(block.mlp.c_fc.weight, (2 * width) ** -0.5)
            normal_(block.mlp.c_proj.weight, proj_std)

    for mod in model.modules():
        if isinstance(mod, Linear):
            normal_(mod.weight, mod.weight.shape[1] ** -0.5)
            mod.bias.zero_()
        elif isinstance(mod, (MultiHeadAttention, CrossAttention)) and hasattr(
                mod, "in_proj_weight"):
            normal_(mod.in_proj_weight, mod.in_proj_weight.shape[1] ** -0.5)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, PatchEmbed):
            normal_(mod.weight, mod.weight[0].numel() ** -0.5)
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.02)
        elif isinstance(mod, AttentionalPooler):
            normal_(mod.query, mod.query.shape[1] ** -0.5)
    vis, cfg = model.visual, model.cfg
    width = cfg.vision_cfg.width
    for p in (vis.class_embedding, vis.positional_embedding, vis.proj):
        normal_(p, width ** -0.5)
    if cfg.vision_cfg.pos_embed_type == "sin_cos_2d":
        vis.positional_embedding.copy_(torch.from_numpy(get_2d_sincos_pos_embed(
            width, cfg.vision_cfg.grid_size[0], cls_token=True)))
    tw, tl = cfg.text_cfg.width, cfg.text_cfg.layers
    normal_(model.positional_embedding, 0.01)
    if isinstance(model.text_projection, nn.Parameter):
        normal_(model.text_projection, tw ** -0.5)
    scaled_blocks(model.transformer.resblocks, tw, tl)
    if isinstance(model, CoCa):
        normal_(model.cls_emb, 0.01)
        dec, mcfg = model.text_decoder, model.multimodal_cfg
        scaled_blocks([*dec.resblocks, *dec.cross_attn], mcfg.width, mcfg.layers)
        normal_(dec.text_projection, mcfg.width ** -0.5)
    model.logit_scale.fill_(cfg.init_logit_scale)


def create_model(model_name: str, device: Union[str, torch.device],
                 dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
                 param_dtype: torch.dtype = torch.float32,
                 quick_gelu: Optional[bool] = None,
                 force_image_size: Optional[int] = None, alpha: Optional[float] = None,
                 gelu_approximate: Optional[bool] = None,
                 grad_checkpointing: bool = False,
                 force_patch_dropout: Optional[float] = None,
                 image_mean: Optional[Sequence[float]] = None,
                 image_std: Optional[Sequence[float]] = None) -> Tuple[CLIP, CLIPCfg]:
    """(model on ``device`` in eval mode, its config), seeded random init in
    fp32 (the same numbers whatever the dtypes), then ``cast_params_`` to
    ``param_dtype`` (bf16 under 'pure_bf16'). ``dtype`` is the compute dtype.
    ``grad_checkpointing`` recomputes each residual block in the backward."""
    cfg = model_config(model_name, quick_gelu, force_image_size=force_image_size,
                       alpha=alpha, gelu_approximate=gelu_approximate,
                       force_patch_dropout=force_patch_dropout,
                       image_mean=image_mean, image_std=image_std)
    if "coca" in model_name.lower():
        model = CoCa(cfg, multimodal_config(model_name) or MultimodalCfg(), dtype=dtype,
                     grad_checkpointing=grad_checkpointing)
    else:
        cls = ColXLIP if "colxlip" in model_name.lower() else CLIP
        model = cls(cfg, dtype=dtype, grad_checkpointing=grad_checkpointing)
    init_weights(model, torch.Generator(device="cpu").manual_seed(seed))
    if param_dtype != torch.float32:
        cast_params_(model, param_dtype)
    return model.to(device).eval(), cfg


def create_teacher(model_name: str, checkpoint_path: str, device: Union[str, torch.device],
                   dtype: torch.dtype = torch.bfloat16, *, seed: int = 0) -> nn.Module:
    """A distillation teacher: ``create_model`` loaded from an OpenCLIP-layout
    ``.pt`` (``load_weights``), in eval mode, with no parameter that takes
    a gradient (the train step never hands them to the optimizer)."""
    teacher, _ = create_model(model_name, device, dtype, seed=seed)
    load_weights(teacher, checkpoint_path)
    return teacher.eval().requires_grad_(False)


def resize_vision_pos_embed(sd: Dict[str, torch.Tensor], new_grid: Tuple[int, int]
                            ) -> Dict[str, torch.Tensor]:
    """Bicubic-resample ``visual.positional_embedding`` of a state dict (a
    class row plus a square grid) to ``new_grid``, as the JAX loader does when
    a checkpoint meets another image size."""
    pe = sd["visual.positional_embedding"]
    old = int(round((pe.shape[0] - 1) ** 0.5))
    if (old, old) == tuple(new_grid):
        return sd
    logger.info("resizing vision pos embed %dx%d -> %dx%d", old, old, *new_grid)
    resized = interpolate_pos_embed(pe.float().numpy(), tuple(new_grid), (old, old))
    return {**sd, "visual.positional_embedding": torch.from_numpy(np.ascontiguousarray(resized))}


def load_weights(model: CLIP, checkpoint_path: str) -> None:
    """Load an OpenCLIP-layout .pt checkpoint into ``model``. Every key must
    match, except that a plain-CLIP checkpoint may leave a ColXLIP model's
    token heads at their init (the JAX package's tag-strip reuse). A vision
    positional embedding trained at another image size is resized to the
    model's patch grid (``--pretrained`` with ``--force-image-size``)."""
    sd = load_pt_state_dict(checkpoint_path)
    if "visual.positional_embedding" in sd:
        sd = resize_vision_pos_embed(sd, model.cfg.vision_cfg.grid_size)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    heads = ("vision_token_layer.", "text_token_layer.")
    missing = [k for k in missing if not k.startswith(heads)]
    if missing or unexpected:
        raise RuntimeError(f"{checkpoint_path}: missing keys {missing[:8]}, "
                           f"unexpected keys {unexpected[:8]}")


def resolve_weights(model_name: str, pretrained: str, cfg: CLIPCfg) -> str:
    """``--pretrained``: a local path as it is, else a tag or ``hf-hub:``
    through ``pretrained.resolve_pretrained`` (fetched into its cache), with
    the JAX warning when a QuickGELU tag meets a model config without it."""
    if os.path.exists(pretrained):
        return pretrained
    if pretrained in QUICK_GELU_TAGS and not cfg.quick_gelu:
        logger.warning("pretrained tag %r was trained with QuickGELU but this model config has "
                       "quick_gelu=False — pass quick_gelu=True (--force-quick-gelu) or "
                       "activations will silently diverge from the checkpoint's", pretrained)
    return resolve_pretrained(model_name, pretrained)


def create_model_and_transforms(
        model_name: str, pretrained: Optional[str] = None, *,
        device: Union[str, torch.device], precision: str = "bf16",
        quick_gelu: Optional[bool] = None, force_image_size: Optional[int] = None,
        grad_checkpointing: bool = False, alpha: float = 0.5,
        gelu_approximate: bool = False, seed: int = 0,
        force_patch_dropout: Optional[float] = None,
        image_mean: Optional[Sequence[float]] = None,
        image_std: Optional[Sequence[float]] = None,
        aug_cfg: Optional[AugmentationCfg] = None, normalize_on_device: bool = False,
        raw_aug: str = "rrc", ship: str = "rgb"
) -> Tuple[CLIP, CLIPCfg, ImageTransform, ImageTransform]:
    """(model in train mode on ``device``, cfg, preprocess_train,
    preprocess_val), as the JAX ``create_model_and_transforms`` builds them.
    The parameters live in the model; ``pretrained`` is a local
    OpenCLIP-layout ``.pt``, a tag of ``pretrained.PRETRAINED`` or
    ``hf-hub:<repo>`` (``resolve_weights``), loaded through ``load_weights``. ``image_mean`` /
    ``image_std`` default to the model config's and, when given, override
    the tower's normalisation of uint8 images and both transforms.

    ``preprocess_train`` is the RandomResizedCrop transform (``aug_cfg``'s
    ranges, ``raw_aug`` for packed records); with ``normalize_on_device`` it
    emits uint8 RGB, and with ``ship='yuv420'`` the pipeline ships planar
    YUV420 batches. ``preprocess_val`` takes the uint8 output too under
    either flag (the device normalises it to the same numbers) but never
    YUV420, which is lossy. As in the JAX factory, the train transform's own
    generator is unseeded: the pipeline hands it a seeded one a sample."""
    model, cfg = create_model(
        model_name, device, compute_dtype(precision), seed=seed,
        param_dtype=param_dtype(precision), quick_gelu=quick_gelu,
        force_image_size=force_image_size, alpha=alpha,
        gelu_approximate=gelu_approximate, grad_checkpointing=grad_checkpointing,
        force_patch_dropout=force_patch_dropout, image_mean=image_mean,
        image_std=image_std)
    if pretrained:
        load_weights(model, resolve_weights(model_name, pretrained, cfg))
    size, mean, std = (cfg.vision_cfg.image_size, tuple(cfg.vision_cfg.image_mean),
                       tuple(cfg.vision_cfg.image_std))
    preprocess_train = image_transform(
        size, is_train=True, mean=mean, std=std, aug_cfg=aug_cfg,
        normalize_on_device=normalize_on_device, raw_aug=raw_aug, ship=ship)
    preprocess_val = image_transform(
        size, is_train=False, mean=mean, std=std,
        normalize_on_device=normalize_on_device or ship == "yuv420")
    return model.train(), cfg, preprocess_train, preprocess_val


def get_tokenizer(model_name: str = "", context_length: Optional[int] = None,
                  require_merges: bool = False) -> SimpleTokenizer:
    """Tokenizer at a registered model's context length.
    ``require_merges=True`` raises when the real CLIP BPE merge table is
    absent: pass it whenever pretrained weights are in play, because the
    zero-merges fallback silently breaks text parity with the checkpoint."""
    if context_length is None:
        cfg_dict = get_model_config(model_name) if model_name else None
        context_length = (cfg_dict or {}).get("text_cfg", {}).get("context_length", 77)
    tokenizer = SimpleTokenizer(context_length=context_length)
    if require_merges and not tokenizer.has_merges:
        raise RuntimeError("the CLIP BPE merge table is missing and pretrained weights "
                           "need it (set $COLXLIP_BPE_PATH, or pass "
                           "--allow-degraded-tokenizer to accept wrong text parity)")
    return tokenizer


def create_loss(args):
    """Map the entry point's flags to the train step's loss config: 'coca' in
    the model name -> coca; a distill pair -> distill; --siglip -> siglip;
    'colxlip' in the name -> colclip; else clip (the only contrastive loss
    that honours ``ce_impl``)."""
    from .parallel.train_step import TrainStepConfig

    model_name = getattr(args, "model", "")
    if "coca" in model_name.lower():
        loss_type = "coca"
    elif getattr(args, "distill_model", None) and getattr(args, "distill_pretrained", None):
        loss_type = "distill"
    elif getattr(args, "siglip", False):
        loss_type = "siglip"
    elif "colxlip" in model_name.lower():
        loss_type = "colclip"
    else:
        loss_type = "clip"
    return TrainStepConfig(
        loss_type=loss_type,
        alpha=getattr(args, "alpha", 0.5),
        local_loss=getattr(args, "local_loss", False),
        gather_with_grad=getattr(args, "gather_with_grad", False),
        accum_freq=getattr(args, "accum_freq", 1),
        maxsim_impl=getattr(args, "maxsim_impl", "auto"),
        ce_impl=getattr(args, "ce_impl", "dense"),
        token_dist=getattr(args, "token_dist", "gather"),
        token_neighborhood=getattr(args, "token_neighborhood", 0),
        mask_mode=getattr(args, "token_mask_mode", "nonzero"),
        dist_impl=getattr(args, "dist_impl", None) or "bidir",
        coca_caption_loss_weight=getattr(args, "coca_caption_loss_weight", 2.0),
        coca_contrastive_loss_weight=getattr(args, "coca_contrastive_loss_weight", 1.0),
    )
