"""Tracker memory encoder: fuse pixel features with the predicted mask.

Counterpart of efficientsam3_tpu/models/memory_encoder.py: the mask
downsampler (bilinear resize to 1152x1152, then 4 stride-2 conv + LN2d +
GELU stages to 72x72 and a 1x1 conv to 256 channels), a 1x1 projection of
the pixel features, 2 ConvNeXt (CXBlock) fuser blocks and a 1x1 projection
to the 64-dim memory space. NHWC throughout.

The JAX package runs the resize and the first conv stage as one separable
matmul composition for the TPU's matrix unit; here they are a bilinear
``F.interpolate`` (the resize from 1008 to 1152 is an upscale, where
antialiasing changes nothing and torch's bilinear weights are the JAX
matrices' rows) and a stride-2 ``F.conv2d``, both in fp32. The fuser's 7x7
depthwise convs run on the ``depthwise_conv2d`` kernel on CUDA, whatever
the channel count.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    Conv,
    Dense,
    LayerNorm2d,
    gelu_exact,
    sine_pos_embed_2d,
)
from efficientsam3_tpu_torch.ops.depthwise import depthwise_conv2d


class MaskDownSampler(nn.Module):
    """(B, H, W, 1) mask logits -> (B, H'/16, W'/16, embed_dim) after a
    bilinear resize to interpol_size (H', W')."""

    def __init__(self, embed_dim: int = 256, num_layers: int = 4, interpol_size=(1152, 1152),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.interpol_size = interpol_size
        self.dtype = dtype
        chans = [1] + [4 ** (i + 1) for i in range(num_layers)]
        # stage 0 runs in fp32 outside its module (forward below); the others
        # compute in `dtype`
        self.encoder = nn.ModuleList(
            Conv(chans[i], chans[i + 1], 3, stride=2, padding=1, dtype=dtype if i else None)
            for i in range(num_layers))
        self.encoder_ln = nn.ModuleList(LayerNorm2d(c) for c in chans[1:])
        self.encoder_out = Conv(chans[-1], embed_dim, 1, dtype=dtype)

    def forward(self, x):
        dt = self.dtype or torch.float32
        m = x[..., 0].float()[:, None]  # (B, 1, H, W)
        size = tuple(self.interpol_size or m.shape[-2:])
        if size != tuple(m.shape[-2:]):
            m = F.interpolate(m, size=size, mode="bilinear", align_corners=False)
        k0 = self.encoder[0]
        y = F.conv2d(m, k0.weight.float(), k0.bias.float(), stride=2, padding=1)
        x = gelu_exact(self.encoder_ln[0](y.permute(0, 2, 3, 1).to(dt)))
        for conv, ln in zip(self.encoder[1:], self.encoder_ln[1:]):
            x = gelu_exact(ln(conv(x)))
        return self.encoder_out(x)


class CXBlock(nn.Module):
    """ConvNeXt block: dw7x7 -> LN -> 1x1 -> GELU -> 1x1, layer scale,
    residual."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        # parameter holder: (dim, 1, 7, 7) weight and bias, run by the kernel
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = Dense(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Dense(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        dt = self.dtype or x.dtype
        kernel = self.dwconv.weight.permute(2, 3, 1, 0)  # flax (k, k, 1, C) layout
        y = depthwise_conv2d(x.to(dt), kernel, self.dwconv.bias)
        y = self.pwconv2(gelu_exact(self.pwconv1(self.norm(y))))
        return x + self.gamma * y


class MemoryEncoder(nn.Module):
    """(pixel feats (B, Hm, Wm, C), mask logits (B, H, W, 1)) ->
    (memory (B, Hm, Wm, out_dim), pos (Hm, Wm, out_dim))."""

    def __init__(self, out_dim: int = 64, in_dim: int = 256, num_fuser_layers: int = 2,
                 interpol_size=(1152, 1152), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_dim = out_dim
        self.mask_downsampler = MaskDownSampler(in_dim, interpol_size=interpol_size, dtype=dtype)
        self.pix_feat_proj = Conv(in_dim, in_dim, 1, dtype=dtype)
        self.fuser = nn.ModuleList(CXBlock(in_dim, dtype=dtype) for _ in range(num_fuser_layers))
        self.out_proj = Conv(in_dim, out_dim, 1, dtype=dtype) if out_dim != in_dim else None

    def forward(self, pix_feat, mask_logits, skip_mask_sigmoid: bool = False):
        m = mask_logits if skip_mask_sigmoid else torch.sigmoid(mask_logits)
        # the projection of the (slot-tiled) pixel features comes out NCHW
        # in memory; one copy to NHWC here, where the depthwise kernel of
        # each fuser block (and its backward) would otherwise copy its input
        x = (self.pix_feat_proj(pix_feat) + self.mask_downsampler(m)).contiguous()
        for block in self.fuser:
            x = block(x)
        if self.out_proj is not None:
            x = self.out_proj(x)
        pos = sine_pos_embed_2d(x.shape[1], x.shape[2], self.out_dim, device=x.device)
        return x, pos.to(x.dtype)
