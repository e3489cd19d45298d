"""SimpleFPN dual neck (ViTDet-style), NHWC.

Counterpart of efficientsam3_tpu/models/necks.py: from the trunk map
(72x72x1024) build 4 scales (4x: convT2 -> GELU -> convT2; 2x: convT2;
1x: identity; 0.5x: maxpool2), each followed by 1x1 conv -> 3x3 conv to
d_model, plus sine position embeddings.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    Conv,
    ConvTranspose2x,
    gelu_exact,
    sine_pos_embed_2d,
)


class _ScaleBranch(nn.Module):
    def __init__(self, scale: float, dim: int, d_model: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = scale
        if scale == 4.0:
            self.dconv = nn.ModuleList([
                ConvTranspose2x(dim, dim // 2, dtype=dtype),
                ConvTranspose2x(dim // 2, dim // 4, dtype=dtype),
            ])
            out = dim // 4
        elif scale == 2.0:
            self.dconv = nn.ModuleList([ConvTranspose2x(dim, dim // 2, dtype=dtype)])
            out = dim // 2
        elif scale in (1.0, 0.5):
            out = dim
        else:
            raise ValueError(f"unsupported scale {scale}")
        self.conv_1x1 = Conv(out, d_model, 1, dtype=dtype)
        self.conv_3x3 = Conv(d_model, d_model, 3, padding=1, dtype=dtype)

    def forward(self, x):
        if self.scale == 4.0:
            x = self.dconv[1](gelu_exact(self.dconv[0](x)))
        elif self.scale == 2.0:
            x = self.dconv[0](x)
        elif self.scale == 0.5:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return self.conv_3x3(self.conv_1x1(x))


class SimpleFPNNeck(nn.Module):
    """Trunk map -> list of (feature, pos_embed) per scale."""

    def __init__(self, dim: int, d_model: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
                 num_pos_feats: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.convs = nn.ModuleList(_ScaleBranch(s, dim, d_model, dtype) for s in scale_factors)

    def forward(self, x):
        feats, poss = [], []
        for branch in self.convs:
            f = branch(x)
            pe = sine_pos_embed_2d(f.shape[1], f.shape[2], self.num_pos_feats, device=f.device)
            feats.append(f)
            poss.append(pe.to(f.dtype))
        return feats, poss


class DualFPNNeck(nn.Module):
    """SAM3 neck + optional cloned SAM2 neck over the same trunk output.

    Returns (sam3_feats, sam3_pos, sam2_feats | None, sam2_pos | None).
    """

    def __init__(self, dim: int = 1024, d_model: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
                 add_sam2_neck: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.sam3 = SimpleFPNNeck(dim, d_model, scale_factors, dtype=dtype)
        self.sam2 = SimpleFPNNeck(dim, d_model, scale_factors, dtype=dtype) if add_sam2_neck else None

    def forward(self, x):
        sam3_feats, sam3_pos = self.sam3(x)
        sam2_feats = sam2_pos = None
        if self.sam2 is not None:
            sam2_feats, sam2_pos = self.sam2(x)
        return sam3_feats, sam3_pos, sam2_feats, sam2_pos
