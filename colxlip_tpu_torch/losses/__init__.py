"""Losses: port of ``colxlip_tpu/losses``."""
from .clip import clip_logits, clip_loss, contrastive_labels, cross_entropy_with_integer_labels
from .coca import caption_cross_entropy, coca_loss
from .colclip import colclip_loss
from .distill import distill_clip_loss
from .siglip import siglip_loss

__all__ = ["caption_cross_entropy", "clip_logits", "clip_loss", "coca_loss", "colclip_loss",
           "contrastive_labels", "cross_entropy_with_integer_labels", "distill_clip_loss",
           "siglip_loss"]
