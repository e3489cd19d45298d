"""TinyViT student backbone (5m / 11m / 21m), NHWC.

Counterpart of efficientsam3_tpu/models/tiny_vit.py: a conv patch embed
(stride 4), one MBConv stage, three windowed-attention stages with learned
relative attention biases, and PatchMerging (1x1 -> dw3x3 s2 -> 1x1, all
Conv+BN) between stages. BatchNorm follows flax (``common.BatchNorm``).
DropPath (``common.DropPath``, rates ``linspace(0, drop_path_rate, depth)``
over the blocks as in JAX) draws its masks in training mode from the
``generator`` passed to ``forward``; a variant with ``drop_path_rate`` > 0
(11m, 21m) raises in training mode without one, as flax does without a
"dropout" rng.

Window attention (LeViT-style, at most 14 x 14 = 196 tokens with a full
(heads, N, N) bias gathered from the ``attention_biases`` table) runs on
``common.sdpa``'s matmul path (fp32 logits, P cast to v's dtype), as the
JAX einsums do. Windows are cut by padding the map to a multiple of the
window and reshaping.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    BatchNorm,
    Conv,
    Dense,
    DropPath,
    LayerNorm,
    gelu_exact,
    sdpa,
)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c = Conv(in_features, features, kernel_size, stride, padding, groups=groups,
                      bias=False, dtype=dtype)
        self.bn = BatchNorm(features, 1e-5, dtype=dtype)

    def forward(self, x):
        return self.bn(self.c(x))


class MBConv(nn.Module):
    """Residual MBConv with GELU after the residual, the branch through
    DropPath."""

    def __init__(self, c: int, expand_ratio: float = 4.0, drop_path: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = int(c * expand_ratio)
        self.drop_path = DropPath(drop_path)
        self.conv1 = ConvBN(c, hidden, 1, dtype=dtype)
        self.conv2 = ConvBN(hidden, hidden, 3, 1, 1, groups=hidden, dtype=dtype)
        self.conv3 = ConvBN(hidden, c, 1, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = gelu_exact(self.conv2(gelu_exact(self.conv1(x))))
        return gelu_exact(x + self.drop_path(self.conv3(y), generator))


class PatchMerging(nn.Module):
    """1x1 expand -> GELU -> dw3x3 s2 -> GELU -> 1x1."""

    def __init__(self, in_features: int, out_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = ConvBN(in_features, out_dim, 1, dtype=dtype)
        self.conv2 = ConvBN(out_dim, out_dim, 3, 2, 1, groups=out_dim, dtype=dtype)
        self.conv3 = ConvBN(out_dim, out_dim, 1, dtype=dtype)

    def forward(self, x):
        return self.conv3(gelu_exact(self.conv2(gelu_exact(self.conv1(x)))))


def _attention_bias_idxs(ws: int) -> np.ndarray:
    """(N, N) index table into the unique-offset bias vocabulary."""
    points = list(itertools.product(range(ws), range(ws)))
    offsets = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return np.asarray(idxs, np.int64).reshape(n, n)


class WindowAttention(nn.Module):
    """LeViT-style attention with learned relative biases over (B, N, C)
    window tokens; LayerNorm inside, before the qkv projection."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: int = 1,
                 window_size: int = 7, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.key_dim = key_dim
        self.d = int(attn_ratio * key_dim)
        self.num_heads = num_heads
        self._idxs = _attention_bias_idxs(window_size)
        self._idx_cache = {}  # the index table by device
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, int(self._idxs.max()) + 1))
        self.norm = LayerNorm(dim, 1e-5)
        self.qkv = Dense(dim, (2 * key_dim + self.d) * num_heads, dtype=dtype)
        self.proj = Dense(num_heads * self.d, dim, dtype=dtype)

    def forward(self, x):
        b, n, _ = x.shape
        kd, nh = self.key_dim, self.num_heads
        qkv = self.qkv(self.norm(x)).reshape(b, n, nh, 2 * kd + self.d).transpose(1, 2)
        q, k, v = qkv.split([kd, kd, self.d], dim=-1)
        dev = self.attention_biases.device
        idxs = self._idx_cache.get(dev)
        if idxs is None:
            idxs = self._idx_cache[dev] = torch.from_numpy(self._idxs).to(dev)
        bias = self.attention_biases[:, idxs]  # (nh, N, N)
        out = sdpa(q, k, v, bias=bias[None])
        return self.proj(out.transpose(1, 2).reshape(b, n, nh * self.d))


class TinyViTBlock(nn.Module):
    """Windowed attention + depthwise local conv + MLP, the attention and MLP
    branches through DropPath."""

    def __init__(self, c: int, num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, local_conv_size: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window_size = window_size
        self.drop_path = DropPath(drop_path)
        self.attn = WindowAttention(c, c // num_heads, num_heads, 1, window_size, dtype=dtype)
        self.local_conv = ConvBN(c, c, local_conv_size, 1, local_conv_size // 2, groups=c,
                                 dtype=dtype)
        self.mlp_norm = LayerNorm(c, 1e-5)
        self.mlp_fc1 = Dense(c, int(c * mlp_ratio), dtype=dtype)
        self.mlp_fc2 = Dense(int(c * mlp_ratio), c, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, h, w, c = x.shape
        ws = self.window_size
        if h == ws and w == ws:
            y = self.attn(x.reshape(b, h * w, c)).reshape(b, h, w, c)
        else:
            pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
            y = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
            ph, pw = h + pad_b, w + pad_r
            nh, nw = ph // ws, pw // ws
            y = y.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
            y = self.attn(y.reshape(b * nh * nw, ws * ws, c))
            y = y.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(b, ph, pw, c)[:, :h, :w]
        x = self.local_conv(x + self.drop_path(y, generator))
        z = self.mlp_fc2(gelu_exact(self.mlp_fc1(self.mlp_norm(x))))
        return x + self.drop_path(z, generator)


class TinyViT(nn.Module):
    """Feature trunk: NHWC in, the final stage's NHWC map out (stride 32)."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 256, 448),
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (2, 4, 8, 14),
                 window_sizes: Sequence[int] = (7, 7, 14, 7), mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, mbconv_expand_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = tuple(embed_dims)
        self.depths = tuple(depths)
        self.patch_embed = nn.ModuleList([ConvBN(3, dims[0] // 2, 3, 2, 1, dtype=dtype),
                                          ConvBN(dims[0] // 2, dims[0], 3, 2, 1, dtype=dtype)])
        dpr = iter(np.linspace(0, drop_path_rate, sum(self.depths)).tolist())
        for stage, depth in enumerate(self.depths):
            if stage == 0:
                blocks = [MBConv(dims[0], mbconv_expand_ratio, next(dpr), dtype=dtype)
                          for _ in range(depth)]
            else:
                blocks = [TinyViTBlock(dims[stage], num_heads[stage], window_sizes[stage],
                                       mlp_ratio, next(dpr), dtype=dtype) for _ in range(depth)]
            setattr(self, f"stage{stage}_block", nn.ModuleList(blocks))
        self.downsample = nn.ModuleList(PatchMerging(dims[s], dims[s + 1], dtype=dtype)
                                        for s in range(len(self.depths) - 1))
        self.out_channels = dims[len(self.depths) - 1]

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` draws the DropPath masks in training mode (needed
        at a nonzero ``drop_path_rate``)."""
        x = self.patch_embed[1](gelu_exact(self.patch_embed[0](x)))
        for stage in range(len(self.depths)):
            for blk in getattr(self, f"stage{stage}_block"):
                x = blk(x, generator)
            if stage < len(self.depths) - 1:
                x = self.downsample[stage](x)
        return x


def tiny_vit_5m(**kw):
    return TinyViT((64, 128, 160, 320), (2, 2, 6, 2), (2, 4, 5, 10), (7, 7, 14, 7),
                   drop_path_rate=0.0, **kw)


def tiny_vit_11m(**kw):
    return TinyViT((64, 128, 256, 448), (2, 2, 6, 2), (2, 4, 8, 14), (7, 7, 14, 7),
                   drop_path_rate=0.1, **kw)


def tiny_vit_21m(**kw):
    return TinyViT((96, 192, 384, 576), (2, 2, 6, 2), (3, 6, 12, 18), (7, 7, 14, 7),
                   drop_path_rate=0.2, **kw)


TINYVIT_VARIANTS = {"5m": tiny_vit_5m, "11m": tiny_vit_11m, "21m": tiny_vit_21m}
TINYVIT_OUT_CHANNELS = {"5m": 320, "11m": 448, "21m": 576}
