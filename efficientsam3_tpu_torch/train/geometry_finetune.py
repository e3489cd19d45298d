"""Stage-1 geometry-aware finetune: prompt-in-the-loop distillation.

Counterpart of efficientsam3_tpu/train/geometry_finetune.py (the reference
stage1_geometry_finetune): the student trunk trains inside the frozen SAM3
pipeline (student embedding -> frozen neck -> geometry encoder -> fusion
-> decoder -> seg head), prompted with boxes from the ground truth. The
loss is the embedding MSE (student embedding against the stored teacher
embedding) plus BCE + dice of the best-scoring query's mask against the
teacher-path mask.

Two passes, as in JAX. Pass 1 runs the trunk alone in training mode, which
updates its BatchNorm statistics. Pass 2 runs the whole model in eval mode
(the frozen heads as the reference runs them) on the statistics pass 1
left, under autograd: the gradient of both passes reaches the trunk. In
pass 2 the decoder's boxRPB cross-attention needs a gradient, so it takes
the matmul path, not the forward-only flash_xattn_rpb kernel
(``models.common.xattn_rpb_takes_kernel``); the fusion encoder's attention
and norms run their kernels forward and backward.

Only the trunk trains (optax's multi_transform: clip by the trunk's global
norm + AdamW on the trunk, zero update for the rest): the other parameters
take no gradient at all here.
"""

from __future__ import annotations

import dataclasses

import torch

from efficientsam3_tpu_torch.ops.focal_loss import dice_loss, optax_bce
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear
from efficientsam3_tpu_torch.train.stage1 import masked_mse
from efficientsam3_tpu_torch.train.stage3 import ClippedAdamW, constant_schedule


@dataclasses.dataclass(frozen=True)
class GeometryFinetuneConfig:
    embed_weight: float = 1.0
    mask_bce_weight: float = 1.0
    mask_dice_weight: float = 1.0
    lr: float = 2e-4
    weight_decay: float = 0.05
    grad_clip: float = 5.0


def geometry_labels(model_or_params) -> dict:
    """{parameter name: 'trunk' | 'frozen'} of a model, or of a mapping of
    parameter names: the trunk trains, everything else is frozen."""
    names = (dict(model_or_params.named_parameters())
             if isinstance(model_or_params, torch.nn.Module) else model_or_params)
    return {n: "trunk" if n.split(".", 1)[0] == "trunk" else "frozen" for n in names}


def make_geometry_optimizer(cfg: GeometryFinetuneConfig, model: torch.nn.Module) -> ClippedAdamW:
    """Clip + AdamW at ``cfg.lr`` over the trunk's parameters; turns their
    gradients on and every other parameter's off."""
    model.requires_grad_(False)
    trunk = list(model.trunk.parameters())
    for p in trunk:
        p.requires_grad_(True)
    return ClippedAdamW({"trunk": (trunk, constant_schedule(cfg.lr))}, cfg.weight_decay,
                        cfg.grad_clip)


def geometry_finetune_loss(model, batch: dict, cfg: GeometryFinetuneConfig):
    """(total, {"embed", "bce", "dice"}).

    batch: images (B, H, W, 3), tokens (B, L), prompt (box prompts from the
    ground truth), teacher_embed (B, E, E, C) and valid (B, E, E) for the
    embedding loss, teacher_mask (B, h', w') (resized to the mask head's
    (h, w) bilinearly and thresholded at 0.5 when it differs)."""
    model.trunk.train()
    embed = model.trunk(batch["images"])
    emb_loss = masked_mse(embed, batch["teacher_embed"], batch["valid"])

    model.eval()
    outs = model(batch["images"], batch["tokens"], batch["prompt"])
    best = outs["pred_logits"][..., 0].argmax(1)  # the first of equal scores
    rows = torch.arange(best.shape[0], device=best.device)
    pred_mask = outs["pred_masks"][rows, best].float()
    tgt = batch["teacher_mask"].float()
    if tgt.shape[-2:] != pred_mask.shape[-2:]:
        tgt = (resize_bilinear(tgt[:, None], pred_mask.shape[-2:]) > 0.5)[:, 0].float()
    bce = optax_bce(pred_mask, tgt).mean()
    dl = dice_loss(pred_mask, tgt).mean()
    total = cfg.embed_weight * emb_loss + cfg.mask_bce_weight * bce + cfg.mask_dice_weight * dl
    return total, {"embed": emb_loss, "bce": bce, "dice": dl}


def geometry_finetune_step(model, optimizer: ClippedAdamW, cfg: GeometryFinetuneConfig,
                           batch: dict) -> dict:
    """One finetune step; updates the trunk's parameters and BatchNorm
    statistics in place and leaves the model in eval mode. Returns loss,
    embed, bce and dice as 0-d tensors."""
    optimizer.zero_grad()
    loss, parts = geometry_finetune_loss(model, batch, cfg)
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
