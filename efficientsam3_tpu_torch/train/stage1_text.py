"""Stage-1 text distillation (SAM3-LiteText): a MobileCLIP student against
the teacher's token features.

Counterpart of efficientsam3_tpu/train/stage1_text.py, the reference
stage1/train_text_encoder_stage1.py: token-level masked MSE and cosine on
the projected (256-d) token features, plus the permutation-consistency
loss: the student's (original - word-permuted) feature delta must match
the teacher's. The teacher's features come precomputed, for the tokens and
for their permuted copies.

The step runs the student twice in training mode (the tokens, then the
permuted tokens), so the 'mct' tower's BatchNorm statistics update after
each pass, in that order, as flax's ``mutable=["batch_stats"]`` threads
them. The optimizer is optax's chain(clip_by_global_norm(grad_clip),
adamw(base_lr, weight_decay)) over every parameter at a constant rate
(``stage3.ClippedAdamW``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from efficientsam3_tpu_torch.models.mobile_clip import TextStudentEncoder
from efficientsam3_tpu_torch.train.stage3 import ClippedAdamW, constant_schedule


@dataclasses.dataclass(frozen=True)
class Stage1TextConfig:
    backbone_type: str = "MobileCLIP-S0"
    context_length: int = 32
    output_dim: int = 256
    mse_weight: float = 1.0
    cosine_weight: float = 1.0
    permutation_weight: float = 1.0
    base_lr: float = 1e-3
    weight_decay: float = 0.05
    grad_clip: float = 5.0


def make_text_student(cfg: Stage1TextConfig, dtype: Optional[torch.dtype] = None):
    """The student tower, parameters uninitialised (the caller loads or
    draws them: ``build.init_parameters``)."""
    return TextStudentEncoder(cfg.backbone_type, cfg.context_length, cfg.output_dim, dtype=dtype)


def make_text_optimizer(cfg: Stage1TextConfig, model: torch.nn.Module) -> ClippedAdamW:
    """Clip by global norm + AdamW at ``base_lr`` over every parameter of the
    student; turns their gradients on."""
    model.requires_grad_(True)
    return ClippedAdamW({"text": (list(model.parameters()), constant_schedule(cfg.base_lr))},
                        cfg.weight_decay, cfg.grad_clip)


def _masked_mean(per_token, valid):
    return (per_token * valid).sum() / valid.sum().clamp_min(1.0)


def masked_token_mse(pred, target, valid):
    """pred / target (B, L, C); valid (B, L), 1.0 on real tokens."""
    return _masked_mean((pred.float() - target.float()).square().mean(-1), valid)


def masked_token_cosine(pred, target, valid):
    p, t = pred.float(), target.float()
    cos = (p * t).sum(-1) / (torch.linalg.vector_norm(p, dim=-1)
                             * torch.linalg.vector_norm(t, dim=-1) + 1e-6)
    return _masked_mean(1.0 - cos, valid)


def permutation_consistency(pred, pred_perm, tgt, tgt_perm, valid):
    """The student's (original - permuted) feature delta against the
    teacher's."""
    dp = (pred - pred_perm).float()
    dt = (tgt - tgt_perm).float()
    return _masked_mean((dp - dt).square().mean(-1), valid)


def stage1_text_loss(model, batch: dict, cfg: Stage1TextConfig):
    """(total, {"mse", "cosine", "perm"}) of the student in training mode.
    batch: tokens (B, L), tokens_perm (B, L), teacher (B, L, C),
    teacher_perm (B, L, C)."""
    model.train()
    pred, _ = model(batch["tokens"])
    pred_perm, _ = model(batch["tokens_perm"])
    valid = (batch["tokens"] != 0).float()
    mse = masked_token_mse(pred, batch["teacher"], valid)
    cos = masked_token_cosine(pred, batch["teacher"], valid)
    perm = permutation_consistency(pred, pred_perm, batch["teacher"], batch["teacher_perm"],
                                   valid)
    total = cfg.mse_weight * mse + cfg.cosine_weight * cos + cfg.permutation_weight * perm
    return total, {"mse": mse, "cosine": cos, "perm": perm}


def stage1_text_train_step(model, optimizer: ClippedAdamW, cfg: Stage1TextConfig,
                           batch: dict) -> dict:
    """One distillation step; updates the student's parameters and
    BatchNorm statistics in place. batch as ``stage1_text_loss`` takes it
    (tensors on the model's device). Returns loss, mse, cosine and perm as
    0-d tensors."""
    optimizer.zero_grad()
    loss, parts = stage1_text_loss(model, batch, cfg)
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}


def permute_words(text: str, rng) -> str:
    """Host-side word permutation of a prompt (``rng``: a numpy Generator)."""
    words = text.split()
    if len(words) < 2:
        return text
    idx = rng.permutation(len(words))
    return " ".join(words[i] for i in idx)
