"""Contrastive losses: port of ``colxlip_tpu/losses`` (single device)."""
from .clip import clip_logits, clip_loss, contrastive_labels, cross_entropy_with_integer_labels
from .colclip import colclip_loss

__all__ = ["clip_logits", "clip_loss", "colclip_loss", "contrastive_labels",
           "cross_entropy_with_integer_labels"]
