"""Sigmoid focal loss, BCE-with-logits and dice loss of the training losses.

Counterpart of efficientsam3_tpu/ops/focal_loss.py. ``sigmoid_focal_loss``
keeps the JAX package's custom VJP as an autograd Function: its backward is
the analytic derivative, with the same guards (gamma 0 drops the
modulating term, whose autograd derivative is 0 * inf = NaN once a logit
saturates; (1 - p_t) ** (gamma - 1) is clamped away from 0), and the
targets get a zero gradient. Elementwise PyTorch on either device.
"""

from __future__ import annotations

import torch


def optax_bce(logits, targets):
    """Numerically stable BCE-with-logits (optax's formula)."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _focal(logits, targets, alpha, gamma):
    p = torch.sigmoid(logits)
    ce = optax_bce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


class _SigmoidFocalLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, alpha, gamma):
        ctx.save_for_backward(logits, targets)
        ctx.alpha, ctx.gamma = alpha, gamma
        return _focal(logits, targets, alpha, gamma)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        alpha, gamma = ctx.alpha, ctx.gamma
        p = torch.sigmoid(logits)
        ce = optax_bce(logits, targets)
        one_m = 1 - (p * targets + (1 - p) * (1 - targets))
        dce_dx = p - targets
        dpt_dx = (2 * targets - 1) * p * (1 - p)
        if gamma == 0.0:
            dloss = dce_dx
        else:
            one_m_safe = one_m.clamp_min(torch.finfo(p.dtype).tiny)
            dloss = one_m ** gamma * dce_dx - gamma * one_m_safe ** (gamma - 1.0) * dpt_dx * ce
        if alpha >= 0:
            dloss = (alpha * targets + (1 - alpha) * (1 - targets)) * dloss
        dtargets = torch.zeros_like(targets) if ctx.needs_input_grad[1] else None
        return g * dloss, dtargets, None, None


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Per-element focal loss (no reduction), torchvision semantics."""
    return _SigmoidFocalLoss.apply(logits, targets, alpha, gamma)


def dice_loss(pred_logits, targets, eps: float = 1.0):
    """Dice loss of each flattened mask: (N, ...) logits and targets -> (N,)."""
    p = torch.sigmoid(pred_logits).reshape(pred_logits.shape[0], -1)
    t = targets.reshape(targets.shape[0], -1)
    return 1 - (2 * (p * t).sum(-1) + eps) / (p.sum(-1) + t.sum(-1) + eps)
