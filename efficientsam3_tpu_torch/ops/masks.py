"""Box IoU helpers of the matcher and the detection losses.

Counterpart of the box part of efficientsam3_tpu/ops/masks.py
(``box_iou_xyxy``, ``generalized_box_iou``); its mask IoU and NMS wait for
the video pipeline's port.
"""

from __future__ import annotations

import torch


def box_iou_xyxy(a, b, eps: float = 1e-6):
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M) IoU."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp_min(eps)


def generalized_box_iou(a, b, eps: float = 1e-6):
    """(..., N, M) GIoU matrix of xyxy boxes."""
    iou = box_iou_xyxy(a, b, eps)
    tl = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp_min(0.0)
    hull = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    inter_wh = (torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
                - torch.maximum(a[..., :, None, :2], b[..., None, :, :2])).clamp_min(0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return iou - (hull - union) / hull.clamp_min(eps)
