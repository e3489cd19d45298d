"""Hungarian matching for DETR-style training.

Counterpart of efficientsam3_tpu/train/matcher.py (the reference's
BinaryHungarianMatcherV2: focal class cost + L1 + GIoU with weights 2/5/2,
alpha 0.25, gamma 2). The cost matrix is built on the device, batched over
padded targets (a padded target costs BIG_COST for every query); it is
copied to the host once (one synchronising copy of the stacked
(S * B, T, Q) cost per training step) and solved there by the
``ops/hungarian`` solver, whose assignments are the JAX package's: its
native form for predictions on the card, its NumPy form on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from efficientsam3_tpu_torch.models.decoder import box_cxcywh_to_xyxy
from efficientsam3_tpu_torch.ops.hungarian import (
    solve_assignment_batched,
    solve_assignment_native,
)
from efficientsam3_tpu_torch.ops.masks import generalized_box_iou

BIG_COST = 1e6


@torch.no_grad()
def hungarian_match(pred_logits, pred_boxes, tgt_boxes, tgt_valid, cost_class: float = 2.0,
                    cost_bbox: float = 5.0, cost_giou: float = 2.0, alpha: float = 0.25,
                    gamma: float = 2.0):
    """pred_logits (B, Q, 1), pred_boxes (B, Q, 4) cxcywh, tgt_boxes
    (B, T, 4) cxcywh padded, tgt_valid (B, T) bool -> (assigned query
    (B, T) int64 on the predictions' device, tgt_valid)."""
    s = pred_logits[..., 0].float()
    prob = torch.sigmoid(s)
    c_class = (-alpha * (1 - prob) ** gamma * F.logsigmoid(s)
               + (1 - alpha) * prob ** gamma * F.logsigmoid(-s))[:, :, None]
    pb, tb = pred_boxes.float(), tgt_boxes.float()
    c_bbox = (pb[:, :, None] - tb[:, None, :]).abs().sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(pb), box_cxcywh_to_xyxy(tb))
    cost = cost_class * c_class + cost_bbox * c_bbox - cost_giou * giou
    cost = torch.where(tgt_valid[:, None, :], cost, torch.full_like(cost, BIG_COST))
    cost = torch.nan_to_num(cost, nan=BIG_COST, posinf=BIG_COST, neginf=-BIG_COST)
    # rows = targets, columns = queries (T <= Q)
    solve = solve_assignment_native if cost.is_cuda else solve_assignment_batched
    assigned = solve(cost.transpose(1, 2).cpu().numpy())
    return torch.from_numpy(assigned).long().to(pred_logits.device), tgt_valid
