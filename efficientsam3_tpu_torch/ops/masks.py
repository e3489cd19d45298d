"""Mask and box utilities: IoU matrices, masks -> boxes, greedy NMS.

Counterpart of efficientsam3_tpu/ops/masks.py: the box helpers of the
matcher and the detection losses (``box_iou_xyxy``, ``generalized_box_iou``)
and the video pipeline's mask IoU matrix, ``masks_to_boxes`` and greedy NMS
over masks or boxes. The intersection matrix is one (N, HW) x (HW, M) fp32
matrix product (exact for 0/1 masks under 2^24 pixels), left to
``torch.matmul`` as the JAX package left its einsum to XLA.
"""

from __future__ import annotations

import torch


def mask_intersection_matrix(a, b):
    """a (N, H, W) bool/float, b (M, H, W) -> (N, M) intersection areas."""
    af = a.reshape(a.shape[0], -1).float()
    bf = b.reshape(b.shape[0], -1).float()
    return torch.matmul(af, bf.T)


def mask_iou(a, b, eps: float = 1e-6):
    """(N, M) IoU matrix between two sets of boolean masks."""
    inter = mask_intersection_matrix(a, b)
    area_a = a.reshape(a.shape[0], -1).float().sum(-1)
    area_b = b.reshape(b.shape[0], -1).float().sum(-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(eps)


def masks_to_boxes(masks):
    """(N, H, W) bool -> (N, 4) xyxy of the set pixels' extent (inclusive
    pixel indices); empty masks give zeros."""
    n, h, w = masks.shape
    m = masks.bool()
    any_y, any_x = m.any(dim=2), m.any(dim=1)  # (N, H), (N, W)
    ys = torch.arange(h, dtype=torch.float32, device=m.device)
    xs = torch.arange(w, dtype=torch.float32, device=m.device)
    big = 1e9
    y0 = torch.where(any_y, ys, big).amin(1)
    y1 = torch.where(any_y, ys, -big).amax(1)
    x0 = torch.where(any_x, xs, big).amin(1)
    x1 = torch.where(any_x, xs, -big).amax(1)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1)
    return torch.where(m.any(dim=2).any(dim=1)[:, None], boxes, 0.0)


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


def greedy_nms_from_iou(iou, scores, iou_threshold: float = 0.5):
    """Greedy NMS given a full (N, N) IoU matrix and scores: keep (N,) bool.
    Candidates go in descending score order (ties by index); one is kept iff
    no kept higher-scoring candidate overlaps it above the threshold. The
    loop's data dependence is inherent, so it runs on the host over the
    (small) matrix; the result returns on the inputs' device."""
    n = scores.shape[0]
    order = torch.argsort(-scores.float(), stable=True).cpu().numpy()
    over = (iou > iou_threshold).cpu().numpy()
    keep = [False] * n
    kept = []
    for i in order:
        if not any(over[i, j] for j in kept):
            keep[i] = True
            kept.append(i)
    return torch.tensor(keep, dtype=torch.bool, device=scores.device)


def nms_masks(masks, scores, iou_threshold: float = 0.5):
    """Mask NMS: the mask IoU matrix, then greedy suppression."""
    return greedy_nms_from_iou(mask_iou(masks, masks), scores, iou_threshold)


def nms_boxes(boxes_xyxy, scores, iou_threshold: float = 0.5):
    return greedy_nms_from_iou(box_iou_xyxy(boxes_xyxy, boxes_xyxy), scores, iou_threshold)
