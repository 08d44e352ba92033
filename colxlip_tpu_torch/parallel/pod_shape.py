"""One card's share of the pod-scale colclip recipe: port of
``colxlip_tpu/parallel/pod_shape.py``.

The pod recipes (``scripts/train_merged30m_v5e64.sh``,
``scripts/train_vitl14_v5e64.sh``) run ``--local-loss --token-dist ring
--token-neighborhood K --gather-with-grad`` at batch b a device across M
devices. Each device's step computes:

  - the towers forward and backward on its b local pairs;
  - the pooled InfoNCE: [b, M*b] logit rows in both directions and their
    backward (the local-loss form of ``losses/colclip.py``);
  - the token CE: K block MaxSims a direction over the ring window and their
    backward, including the gradients for the remote blocks (what
    ``gather_with_grad`` sends back around the ring);

everything but the transport (the ring's sends and the all-gathers, which
overlap compute on a pod). This module reproduces that per-device compute
on ONE device, so a single card measures the recipe's img/s a device
instead of projecting it: the remote feature blocks are stand-ins, rolled
copies of the local block. Each roll is a distinct row permutation of a
parameter-dependent tensor, so every block MaxSim and the bank products are
real work, and the backward computes d(bank) for the whole window and folds
it back into d(local) through the rolls. The loss is the mesh loss's math
(CE layouts, labels, block order): ``tests/test_torch_pod_shape.py`` feeds
TRUE per-rank banks and matches the JAX 8-device mesh loss.

MaxSim launches a step: under ``window_mode='scan'`` K forward and K
backward calls a direction (2K each way); under ``'fused'`` one call a
direction over the [K*b, L, D] window (2 each way).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..losses.clip import cross_entropy_with_integer_labels, matmul_t
from ..ops.maxsim import maxsim
from .train_step import TrainStep, TrainStepConfig

WINDOW_MODES = ("scan", "fused")


def _blockwise_rows(local: torch.Tensor, blocks: torch.Tensor, *, transpose: bool,
                    maxsim_impl: str, mask_mode: str,
                    window_mode: str = "scan") -> torch.Tensor:
    """[b_rows, K*b] fp32 MaxSim rows of ``local`` over the K blocks of
    ``blocks`` [K, b, L, D]; column slot s*b holds block s (the positives on
    the slot-0 diagonal). ``transpose``: ``local`` holds image tokens and the
    blocks text tokens, so each block's scores are taken text-major and
    transposed.

    'scan': one MaxSim call a block, the single-device analogue of the ring's
    block loop. 'fused': one call over the flattened [K*b, L, D] window, the
    analogue of all-gathering the capped neighbourhood at once."""
    if window_mode not in WINDOW_MODES:
        raise ValueError(f"unknown window_mode: {window_mode!r} (one of {WINDOW_MODES})")
    kw = dict(mask_mode=mask_mode, impl=maxsim_impl)
    k, b_block = blocks.shape[0], blocks.shape[1]
    if window_mode == "fused":
        window = blocks.reshape(k * b_block, *blocks.shape[2:])
        if not transpose:
            return maxsim(local, window, **kw).float()
        return maxsim(window, local, **kw).T.float()
    cols = [maxsim(local, blocks[s], **kw) if not transpose
            else maxsim(blocks[s], local, **kw).T for s in range(k)]
    return torch.cat(cols, dim=1).float()


def pod_shape_loss(image_features: torch.Tensor,          # [b, D] local
                   text_features: torch.Tensor,           # [b, D] local
                   token_image_features: torch.Tensor,    # [b, Li, D] local
                   token_text_features: torch.Tensor,     # [b, Lt, D] local
                   logit_scale: torch.Tensor, *,
                   all_image: torch.Tensor,               # [M*b, D] pooled image bank
                   all_text: torch.Tensor,                # [M*b, D] pooled text bank
                   tok_image_blocks: torch.Tensor,        # [K, b, Li, D] ring window;
                   tok_text_blocks: torch.Tensor,         # [K, b, Lt, D] slot 0 = local
                   alpha: float = 0.5, maxsim_impl: str = "auto",
                   mask_mode: str = "nonzero",
                   label_offset: int = 0,                 # rank * b in the real layout
                   window_mode: str = "scan", output_dict: bool = True):
    """The per-device loss of the local-loss + ring (+ neighbourhood)
    recipe, with the banks the collectives would produce passed in. Equal to
    the sharded branch of ``losses/colclip.py`` when the banks are the true
    per-rank blocks; the pod step feeds rolled stand-ins of the same shapes."""
    b = image_features.shape[0]
    logits_per_image = logit_scale * matmul_t(image_features, all_text)
    logits_per_text = logit_scale * matmul_t(text_features, all_image)
    rkw = dict(maxsim_impl=maxsim_impl, mask_mode=mask_mode, window_mode=window_mode)
    s_text = _blockwise_rows(token_text_features, tok_image_blocks, transpose=False, **rkw)
    s_image = _blockwise_rows(token_image_features, tok_text_blocks, transpose=True, **rkw)
    logits_per_text_token = logit_scale * s_text
    logits_per_image_token = logit_scale * s_image

    labels = torch.arange(b, device=logits_per_image.device) + label_offset
    token_labels = torch.arange(b, device=logits_per_image.device)   # slot-0 diagonal
    global_contrastive_loss = (
        cross_entropy_with_integer_labels(logits_per_image, labels)
        + cross_entropy_with_integer_labels(logits_per_text, labels)) / 2
    token_contrastive_loss = (
        cross_entropy_with_integer_labels(logits_per_image_token, token_labels)
        + cross_entropy_with_integer_labels(logits_per_text_token, token_labels)) / 2
    total = alpha * global_contrastive_loss + (1 - alpha) * token_contrastive_loss
    if output_dict:
        return {"global_contrastive_loss": global_contrastive_loss,
                "token_contrastive_loss": token_contrastive_loss,
                "total_loss": total}
    return total


def make_pod_banks(out: Dict[str, torch.Tensor], *, neighborhood: int, pod_devices: int,
                   gather_with_grad: bool = True) -> Dict[str, torch.Tensor]:
    """Stand-in collective banks from the local model outputs: the pooled
    banks are ``pod_devices`` rolled copies (slot 0 unrolled: the
    positives), the token windows K = ``neighborhood or pod_devices`` rolled
    blocks. Without ``gather_with_grad`` the banks are detached (the
    reference local-loss default: the gathered side carries no gradient)."""
    k = neighborhood or pod_devices

    def rolls(x: torch.Tensor, n: int):
        return [x if s == 0 else torch.roll(x, s, dims=0) for s in range(n)]

    banks = {
        "all_image": torch.cat(rolls(out["image_features"], pod_devices)),
        "all_text": torch.cat(rolls(out["text_features"], pod_devices)),
        "tok_image_blocks": torch.stack(rolls(out["token_image_features"], k)),
        "tok_text_blocks": torch.stack(rolls(out["token_text_features"], k)),
    }
    if not gather_with_grad:
        banks = {name: bank.detach() for name, bank in banks.items()}
    return banks


class PodShapeStep(TrainStep):
    """``TrainStep`` whose loss is one device's share of the M-device
    local-loss + ring recipe (``pod_shape_loss`` on ``make_pod_banks``);
    the optimizer step, the clamp and the metrics are ``TrainStep``'s."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]], cfg: TrainStepConfig, *,
                 pod_devices: int, window_mode: str = "scan"):
        if cfg.loss_type != "colclip" or cfg.accum_freq != 1:
            raise ValueError("the pod-shape step runs the colclip loss at accum_freq 1; got "
                             f"loss_type={cfg.loss_type!r}, accum_freq={cfg.accum_freq}")
        super().__init__(model, optimizer, schedule, cfg)
        self.pod_devices = pod_devices
        self.window_mode = window_mode

    def _loss_and_grads(self, images, texts):
        cfg = self.cfg
        out = self.forward(images, texts)
        banks = make_pod_banks(out, neighborhood=cfg.token_neighborhood,
                               pod_devices=self.pod_devices,
                               gather_with_grad=cfg.gather_with_grad)
        losses = pod_shape_loss(
            out["image_features"], out["text_features"], out["token_image_features"],
            out["token_text_features"], out["logit_scale"], alpha=cfg.alpha,
            maxsim_impl=cfg.maxsim_impl, mask_mode=cfg.mask_mode,
            window_mode=self.window_mode, **banks)
        losses["total_loss"].backward()
        return losses, out["logit_scale"]


def make_pod_shape_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                        schedule: Optional[Callable[[int], float]], cfg: TrainStepConfig,
                        *, pod_devices: int, window_mode: str = "scan") -> PodShapeStep:
    """``step(images, texts) -> metrics`` whose compute is one device's share
    of the ``pod_devices``-device recipe (module docstring).
    ``cfg.token_neighborhood`` 0 means the full ring of ``pod_devices``
    blocks; ``cfg.gather_with_grad`` keeps the banks' gradients."""
    return PodShapeStep(model, optimizer, schedule, cfg, pod_devices=pod_devices,
                        window_mode=window_mode)
