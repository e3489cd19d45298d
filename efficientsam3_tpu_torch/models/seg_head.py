"""Segmentation head: pixel decoder + prompt cross-attention + mask and
semantic prediction.

Counterpart of efficientsam3_tpu/models/seg_head.py: 3 nearest-neighbour
upsampling stages with conv3x3 + GroupNorm(8) + relu, one prompt
cross-attention on the fused encoder tokens, instance/semantic 1x1 heads
and the query-to-pixel dot-product masks, NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import MLP, Conv, GroupNorm, LayerNorm, MultiheadAttention


def nearest_upsample_2x(x):
    """NHWC 2x nearest upsample (torch 'nearest' for integer factors)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


class PixelDecoder(nn.Module):
    """FPN top-down merge: upsample + add + conv + GN + relu per stage."""

    def __init__(self, hidden_dim: int = 256, num_stages: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        # the JAX decoder runs len(feats) - 1 stages (2 for the 3-level FPN);
        # norms/convs of unused stages never exist in its parameter tree
        self.conv_layers = nn.ModuleList(
            Conv(hidden_dim, hidden_dim, 3, padding=1, dtype=dtype) for _ in range(num_stages - 1)
        )
        self.norms = nn.ModuleList(
            GroupNorm(8, hidden_dim, 1e-5, dtype=dtype) for _ in range(num_stages - 1)
        )

    def forward(self, feats):
        """feats: NHWC maps fine -> coarse; the last is the starting map."""
        prev = feats[-1]
        for i, cur in enumerate(reversed(feats[:-1])):
            scale = cur.shape[1] // prev.shape[1]
            up = prev
            for _ in range(int(scale).bit_length() - 1):
                up = nearest_upsample_2x(up)
            prev = cur + up
            prev = F.relu(self.norms[i](self.conv_layers[i](prev)))
        return prev


class UniversalSegmentationHead(nn.Module):
    """Returns pred_masks (B, NQ, Hm, Wm) + semantic_seg (B, Hm, Wm, 1)."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = hidden_dim
        self.cross_attn_norm = LayerNorm(d, 1e-5)
        self.cross_attend_prompt = MultiheadAttention(d, num_heads, dtype=dtype)
        self.pixel_decoder = PixelDecoder(d, dtype=dtype)
        self.instance_seg_head = Conv(d, d, 1, dtype=dtype)
        self.semantic_seg_head = Conv(d, 1, 1, dtype=dtype)
        self.mask_embed = MLP(d, d, d, 3)

    def forward(self, backbone_feats, obj_queries, encoder_hidden_states, prompt=None,
                prompt_mask=None):
        d = self.cross_attn_norm.weight.shape[0]
        b, hw, _ = encoder_hidden_states.shape
        if prompt is not None:
            t2 = self.cross_attn_norm(encoder_hidden_states)
            t2 = self.cross_attend_prompt(t2, prompt, prompt, key_padding_mask=prompt_mask)
            encoder_hidden_states = t2 + encoder_hidden_states
        h, w = backbone_feats[-1].shape[1:3]
        if h * w != hw:
            raise ValueError("encoder memory must match the coarsest FPN level")
        enc_map = encoder_hidden_states.reshape(b, h, w, d)
        pixel_embed = self.pixel_decoder(list(backbone_feats[:-1]) + [enc_map])
        instance_embeds = self.instance_seg_head(pixel_embed)
        semantic_seg = self.semantic_seg_head(pixel_embed)
        mask_embed = self.mask_embed(obj_queries)
        masks = torch.einsum("bqc,bhwc->bqhw", mask_embed.float(), instance_embeds.float())
        return {"pred_masks": masks.to(obj_queries.dtype), "semantic_seg": semantic_seg}
