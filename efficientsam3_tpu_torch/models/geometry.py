"""Geometric prompt container + sequence geometry encoder.

Counterpart of efficientsam3_tpu/models/geometry.py: boxes and points are
each encoded by a direct coordinate projection + pooled image features
(roi_align / grid_sample) + a sine position encoding, summed with label
embeddings; a CLS token is appended; a linear + LayerNorm; then 3
FusionEncoderLayers (self-attention over the prompt, cross-attention to
the image tokens with sine positions on the keys). The Prompt keeps the
JAX package's fixed-width padding: "no boxes" is an all-masked row.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    Conv,
    Dense,
    Embed,
    LayerNorm,
    sine_encode_boxes,
    sine_encode_xy,
)
from efficientsam3_tpu_torch.models.decoder import box_cxcywh_to_xyxy
from efficientsam3_tpu_torch.models.fusion_encoder import FusionEncoderLayer
from efficientsam3_tpu_torch.ops.grid_sample import grid_sample
from efficientsam3_tpu_torch.ops.roi_align import roi_align


@dataclass(frozen=True)
class Prompt:
    """Padded geometric prompts, batch-first. Masks: True = PAD."""

    boxes: torch.Tensor  # (B, NB, 4) normalized cxcywh
    box_mask: torch.Tensor  # (B, NB) bool
    box_labels: torch.Tensor  # (B, NB) int (1 = positive, 0 = negative)
    points: torch.Tensor  # (B, NP, 2) normalized xy
    point_mask: torch.Tensor  # (B, NP) bool
    point_labels: torch.Tensor  # (B, NP) int

    @staticmethod
    def empty(batch: int, num_boxes: int = 8, num_points: int = 8, device=None):
        return Prompt(
            boxes=torch.zeros((batch, num_boxes, 4), dtype=torch.float32, device=device),
            box_mask=torch.ones((batch, num_boxes), dtype=torch.bool, device=device),
            box_labels=torch.ones((batch, num_boxes), dtype=torch.int32, device=device),
            points=torch.zeros((batch, num_points, 2), dtype=torch.float32, device=device),
            point_mask=torch.ones((batch, num_points), dtype=torch.bool, device=device),
            point_labels=torch.ones((batch, num_points), dtype=torch.int32, device=device),
        )

    def with_box(self, batch_idx: int, slot: int, box_cxcywh, label: int = 1):
        boxes, box_mask, box_labels = (
            self.boxes.clone(), self.box_mask.clone(), self.box_labels.clone())
        boxes[batch_idx, slot] = torch.as_tensor(box_cxcywh, dtype=torch.float32)
        box_mask[batch_idx, slot] = False
        box_labels[batch_idx, slot] = label
        return replace(self, boxes=boxes, box_mask=box_mask, box_labels=box_labels)

    def with_point(self, batch_idx: int, slot: int, xy, label: int = 1):
        points, point_mask, point_labels = (
            self.points.clone(), self.point_mask.clone(), self.point_labels.clone())
        points[batch_idx, slot] = torch.as_tensor(xy, dtype=torch.float32)
        point_mask[batch_idx, slot] = False
        point_labels[batch_idx, slot] = label
        return replace(self, points=points, point_mask=point_mask, point_labels=point_labels)

    def to(self, device):
        return Prompt(*(getattr(self, f).to(device) for f in self.__dataclass_fields__))


class _TinyDense(nn.Module):
    """Dense with a tiny (2-4) contraction dim, expanded elementwise, as in
    the JAX package (exact in fp32 on every backend)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        out = self.bias.expand(*x.shape[:-1], self.bias.shape[0])
        for i in range(x.shape[-1]):
            out = out + x[..., i:i + 1] * self.weight[:, i]
        return out


class SequenceGeometryEncoder(nn.Module):
    """Prompt -> (B, T, C) tokens + (B, T) pad mask; order [points, boxes, CLS]."""

    def __init__(self, d_model: int = 256, num_layers: int = 3, roi_size: int = 7,
                 num_heads: int = 8, dim_feedforward: int = 2048,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = d_model
        self.d_model = d
        self.roi_size = roi_size
        self.label_embed = Embed(2, d)
        self.img_pre_norm = LayerNorm(d, 1e-5)
        self.points_direct_project = _TinyDense(2, d)
        self.points_pool_project = Dense(d, d, dtype=dtype)
        self.points_pos_enc_project = Dense(d, d, dtype=dtype)
        self.boxes_direct_project = _TinyDense(4, d)
        self.boxes_pool_project = Conv(d, d, roi_size, padding="VALID", dtype=dtype)
        self.boxes_pos_enc_project = Dense(d + 2, d, dtype=dtype)
        self.cls_embed = Embed(1, d)
        self.final_proj = Dense(d, d, dtype=dtype)
        self.norm = LayerNorm(d, 1e-5)
        self.encode = nn.ModuleList(
            FusionEncoderLayer(d, dim_feedforward, num_heads, pos_enc_at_attn=False,
                               pos_enc_at_cross_attn_keys=True,
                               pos_enc_at_cross_attn_queries=False, dtype=dtype)
            for _ in range(num_layers)
        )
        self.encode_norm = LayerNorm(d, 1e-5)

    def forward(self, prompt: Prompt, img_tokens, img_hw, img_pos=None):
        d = self.d_model
        b = prompt.points.shape[0]
        h, w = img_hw
        img_n = self.img_pre_norm(img_tokens)
        img_map = img_n.reshape(b, h, w, d).permute(0, 3, 1, 2)  # NCHW for pooling

        pts = prompt.points.float()
        p_embed = self.points_direct_project(pts)
        grid = (pts * 2.0 - 1.0)[:, :, None, :]
        sampled = grid_sample(img_map, grid)[:, :, :, 0].transpose(1, 2)
        p_embed = p_embed + self.points_pool_project(sampled)
        ex, ey = sine_encode_xy(pts[..., 0], pts[..., 1], d)
        p_embed = p_embed + self.points_pos_enc_project(torch.cat([ex, ey], dim=-1))
        p_embed = p_embed + self.label_embed(prompt.point_labels)

        boxes = prompt.boxes.float()
        nb = boxes.shape[1]
        b_embed = self.boxes_direct_project(boxes)
        scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
        boxes_xyxy = box_cxcywh_to_xyxy(boxes) * scale
        bidx = torch.arange(b, device=boxes.device).repeat_interleave(nb)
        pooled = roi_align(img_map, boxes_xyxy.reshape(b * nb, 4), bidx,
                           (self.roi_size, self.roi_size))
        proj = self.boxes_pool_project(pooled.permute(0, 2, 3, 1))  # (B*NB, 1, 1, C)
        b_embed = b_embed + proj.reshape(b, nb, d)
        enc = sine_encode_boxes(boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3], d)
        b_embed = b_embed + self.boxes_pos_enc_project(enc)
        b_embed = b_embed + self.label_embed(prompt.box_labels)

        cls = self.cls_embed.weight[None].expand(b, 1, d)
        tokens = torch.cat([p_embed, b_embed, cls.to(b_embed.dtype)], dim=1)
        mask = torch.cat([
            prompt.point_mask, prompt.box_mask,
            torch.zeros((b, 1), dtype=torch.bool, device=prompt.box_mask.device),
        ], dim=1)
        tokens = self.norm(self.final_proj(tokens))

        if img_pos is not None and img_pos.ndim == 2:
            img_pos = img_pos[None].expand(img_tokens.shape)
        for layer in self.encode:
            tokens = layer(tokens, img_tokens, query_pos=None, pos=img_pos,
                           tgt_key_padding_mask=mask)
        return self.encode_norm(tokens), mask
