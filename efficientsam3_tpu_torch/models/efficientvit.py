"""EfficientViT student backbone (b0/b1), NHWC.

Counterpart of efficientsam3_tpu/models/efficientvit.py: conv stem with
depthwise-separable blocks, two MBConv stages, two attention stages of
[MBConv-downsample + (LiteMLA + MBConv) x depth]. BatchNorm uses its
running statistics (inference). LiteMLA's ReLU linear attention runs in
fp32, as the JAX code does; convolutions run in the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import BatchNorm, Conv


def hardswish(x):
    return x * F.relu6(x + 3.0) / 6.0


EVIT_ACT = {"hswish": hardswish, "relu": F.relu, "relu6": F.relu6, None: None}


class ConvNormAct(nn.Module):
    """Conv2d + optional BN + optional activation."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, use_bias: bool = False,
                 norm: Optional[str] = "bn2d", act: Optional[str] = "relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(in_features, features, kernel_size, stride, kernel_size // 2,
                         groups=groups, bias=use_bias, dtype=dtype)
        if norm not in ("bn2d", None):
            raise NotImplementedError(f"norm {norm!r}")
        self.norm = BatchNorm(features, 1e-5, dtype=dtype) if norm == "bn2d" else None
        self.act = EVIT_ACT[act]

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class DSConv(nn.Module):
    """Depthwise-separable conv."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_bias=(False, False), norm=("bn2d", "bn2d"), act=("relu6", None),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = in_features
        self.depth_conv = ConvNormAct(c, c, 3, stride, groups=c, use_bias=use_bias[0],
                                      norm=norm[0], act=act[0], dtype=dtype)
        self.point_conv = ConvNormAct(c, features, 1, use_bias=use_bias[1],
                                      norm=norm[1], act=act[1], dtype=dtype)

    def forward(self, x):
        return self.point_conv(self.depth_conv(x))


class MBConv(nn.Module):
    """Inverted-bottleneck conv."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 expand_ratio: float = 4.0, use_bias=(False, False, False),
                 norm=("bn2d", "bn2d", "bn2d"), act=("relu6", "relu6", None),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        mid = round(in_features * expand_ratio)
        self.inverted_conv = ConvNormAct(in_features, mid, 1, use_bias=use_bias[0],
                                         norm=norm[0], act=act[0], dtype=dtype)
        self.depth_conv = ConvNormAct(mid, mid, 3, stride, groups=mid, use_bias=use_bias[1],
                                      norm=norm[1], act=act[1], dtype=dtype)
        self.point_conv = ConvNormAct(mid, features, 1, use_bias=use_bias[2],
                                      norm=norm[2], act=act[2], dtype=dtype)

    def forward(self, x):
        return self.point_conv(self.depth_conv(self.inverted_conv(x)))


class LiteMLA(nn.Module):
    """Lightweight multi-scale linear attention.

    out = (v~ k^T q) with v~ = [v; 1], normalised by the appended ones row,
    in fp32 over (B, HW, groups, d).
    """

    def __init__(self, in_features: int, features: int, head_dim: int = 16,
                 heads_ratio: float = 1.0, scales: Sequence[int] = (5,),
                 eps: float = 1e-15, dtype: Optional[torch.dtype] = None):
        super().__init__()
        heads = int(in_features // head_dim * heads_ratio)
        total = heads * head_dim
        self.d = head_dim
        self.eps = eps
        self.scales = tuple(scales)
        self.qkv = ConvNormAct(in_features, 3 * total, 1, use_bias=False, norm=None, act=None,
                               dtype=dtype)
        for si, s in enumerate(self.scales):
            setattr(self, f"aggreg_{si}_dw",
                    Conv(3 * total, 3 * total, s, 1, s // 2, groups=3 * total, bias=False,
                         dtype=dtype))
            # grouped 1x1 conv: the flax kernel (1, 1, in/g, out) carries over
            # as a grouped Conv2d weight (out, in/g, 1, 1)
            setattr(self, f"aggreg_{si}_pw",
                    Conv(3 * total, 3 * total, 1, groups=3 * heads, bias=False, dtype=dtype))
        self.proj = ConvNormAct(total * (1 + len(self.scales)), features, 1, use_bias=False,
                                norm="bn2d", act=None, dtype=dtype)

    def forward(self, x):
        b, h, w, _ = x.shape
        qkv = self.qkv(x)
        multi = [qkv]
        for si in range(len(self.scales)):
            y = getattr(self, f"aggreg_{si}_dw")(qkv)
            multi.append(getattr(self, f"aggreg_{si}_pw")(y))
        qkv_ms = torch.cat(multi, dim=-1)
        d = self.d
        n_groups = qkv_ms.shape[-1] // (3 * d)
        z = qkv_ms.reshape(b, h * w, n_groups, 3 * d).float()
        q = F.relu(z[..., :d])
        k = F.relu(z[..., d:2 * d])
        v = z[..., 2 * d:]
        v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
        vk = torch.einsum("bngd,bnge->bgde", v1, k)
        out = torch.einsum("bgde,bnge->bngd", vk, q)
        out = out[..., :d] / (out[..., d:] + self.eps)
        out = out.reshape(b, h, w, n_groups * d).to(x.dtype)
        return self.proj(out)


class EfficientViTBlock(nn.Module):
    """LiteMLA (residual) + MBConv (residual)."""

    def __init__(self, c: int, head_dim: int = 16, expand_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.context_module = LiteMLA(c, c, head_dim=head_dim, dtype=dtype)
        self.local_module = MBConv(c, c, expand_ratio=expand_ratio, use_bias=(True, True, False),
                                   norm=(None, None, "bn2d"), act=("hswish", "hswish", None),
                                   dtype=dtype)

    def forward(self, x):
        x = x + self.context_module(x)
        return x + self.local_module(x)


class EfficientViTBackbone(nn.Module):
    """Returns the final-stage feature map (stride 32), NHWC."""

    def __init__(self, width_list=(8, 16, 32, 64, 128), depth_list=(1, 2, 2, 2, 2),
                 head_dim: int = 16, expand_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        w, d = tuple(width_list), tuple(depth_list)
        self.stem_conv = ConvNormAct(3, w[0], 3, 2, norm="bn2d", act="hswish", dtype=dtype)
        self.stem_block = nn.ModuleList(
            DSConv(w[0], w[0], 1, act=("hswish", None), dtype=dtype) for _ in range(d[0])
        )
        cin = w[0]
        for s in (1, 2):
            blocks = []
            for i in range(d[s]):
                blocks.append(MBConv(cin, w[s], 2 if i == 0 else 1, expand_ratio,
                                     act=("hswish", "hswish", None), dtype=dtype))
                cin = w[s]
            setattr(self, f"stage{s}_block", nn.ModuleList(blocks))
        for s in (3, 4):
            setattr(self, f"stage{s}_down",
                    MBConv(cin, w[s], 2, expand_ratio, use_bias=(True, True, False),
                           norm=(None, None, "bn2d"), act=("hswish", "hswish", None),
                           dtype=dtype))
            cin = w[s]
            setattr(self, f"stage{s}_block", nn.ModuleList(
                EfficientViTBlock(cin, head_dim, expand_ratio, dtype=dtype)
                for _ in range(d[s])
            ))

    def forward(self, x):
        x = self.stem_conv(x)
        for blk in self.stem_block:
            x = x + blk(x)
        for s in (1, 2):
            for i, blk in enumerate(getattr(self, f"stage{s}_block")):
                y = blk(x)
                x = y if i == 0 else x + y
        for s in (3, 4):
            x = getattr(self, f"stage{s}_down")(x)
            for blk in getattr(self, f"stage{s}_block"):
                x = blk(x)
        return x


def efficientvit_b0(**kw):
    return EfficientViTBackbone((8, 16, 32, 64, 128), (1, 2, 2, 2, 2), head_dim=16, **kw)


def efficientvit_b1(**kw):
    return EfficientViTBackbone((16, 32, 64, 128, 256), (1, 2, 3, 3, 4), head_dim=16, **kw)


EFFICIENTVIT_VARIANTS = {"b0": efficientvit_b0, "b1": efficientvit_b1}

EFFICIENTVIT_OUT_CHANNELS = {"b0": 128, "b1": 256}
