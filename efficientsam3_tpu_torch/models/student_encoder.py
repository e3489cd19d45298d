"""Student vision encoder: trunk + projection head -> (B, 72, 72, 1024).

Counterpart of efficientsam3_tpu/models/student_encoder.py: the trunk's
stride-32 map goes through 1x1 conv (no bias) + BN + GELU + 3x3 conv, then
a bilinear resize (torch semantics) to the teacher's token grid.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientsam3_tpu_torch.models.common import BatchNorm, Conv, gelu_exact
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear


class _Gelu(nn.Module):
    def forward(self, x):
        return gelu_exact(x)


class StudentProjectionHead(nn.Module):
    """head.0 1x1 conv, head.1 BN, head.2 GELU, head.3 3x3 conv, then resize."""

    def __init__(self, in_features: int, embed_dim: int = 1024, embed_size: int = 72,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_size = embed_size
        self.head = nn.Sequential(
            Conv(in_features, embed_dim, 1, bias=False, dtype=dtype),
            BatchNorm(embed_dim, 1e-5, dtype=dtype),
            _Gelu(),
            Conv(embed_dim, embed_dim, 3, padding=1, dtype=dtype),
        )

    def forward(self, x):
        x = self.head(x)
        if x.shape[1] != self.embed_size or x.shape[2] != self.embed_size:
            x = resize_bilinear(x.permute(0, 3, 1, 2), (self.embed_size, self.embed_size))
            x = x.permute(0, 2, 3, 1)
        return x


class ImageStudentEncoder(nn.Module):
    """trunk -> projection head. Returns (B, embed_size, embed_size, embed_dim)."""

    def __init__(self, trunk: nn.Module, trunk_channels: int, embed_dim: int = 1024,
                 embed_size: int = 72, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.trunk = trunk
        self.head = StudentProjectionHead(trunk_channels, embed_dim, embed_size, dtype=dtype)

    def forward(self, x):
        return self.head(self.trunk(x))
