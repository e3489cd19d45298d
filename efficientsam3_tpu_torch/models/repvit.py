"""RepViT student backbone (m0.9 / m1.1 / m2.3), NHWC.

Counterpart of efficientsam3_tpu/models/repvit.py: a stride-4 conv stem,
then RepViTBlocks. Stride-2 blocks mix tokens with [dw3x3+BN -> optional
SE -> pw1x1+BN]; stride-1 blocks with the re-parameterisable RepVGG mixer
[dw3x3+BN + dw1x1 + identity, then BN] -> optional SE. The channel mixer is
a residual pw-expand (GELU) pw block with BN. BatchNorm uses its running
statistics in eval mode (``common.BatchNorm``, flax's conventions).

``deploy=True`` builds the fused form: every Conv+BN is one biased conv and
the RepVGG mixer one biased dw3x3 conv. ``fuse_repvit_state_dict`` folds a
train-form state_dict into it, as the JAX ``fuse_repvit_params`` folds the
flax tree. The depthwise 3x3 convolutions run as ``F.conv2d(groups=C)``:
the JAX package runs them as flax convs, not through its Pallas depthwise
kernel (which is 7x7).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from efficientsam3_tpu_torch.models.common import BatchNorm, Conv, gelu_exact


def make_divisible(v, divisor=8, min_value=None, round_limit=0.9):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm; in deploy form one biased conv."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, deploy: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c = Conv(in_features, features, kernel_size, stride, padding, groups=groups,
                      bias=deploy, dtype=dtype)
        self.bn = None if deploy else BatchNorm(features, 1e-5, dtype=dtype)

    def forward(self, x):
        x = self.c(x)
        return x if self.bn is None else self.bn(x)


class SqueezeExcite(nn.Module):
    """timm-style SE block, rd_ratio 0.25."""

    def __init__(self, c: int, rd_ratio: float = 0.25, dtype: Optional[torch.dtype] = None):
        super().__init__()
        rd = make_divisible(c * rd_ratio, 8, round_limit=0.0)
        self.fc1 = Conv(c, rd, 1, dtype=dtype)
        self.fc2 = Conv(rd, c, 1, dtype=dtype)

    def forward(self, x):
        se = x.mean(dim=(1, 2), keepdim=True)
        se = self.fc2(torch.relu(self.fc1(se)))
        return x * torch.sigmoid(se)


class RepVGGDW(nn.Module):
    """Depthwise RepVGG mixer: dw3x3+BN + dw1x1 + identity, then BN; in
    deploy form a single biased dw3x3 conv."""

    def __init__(self, c: int, deploy: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.fused = Conv(c, c, 3, 1, 1, groups=c, bias=True, dtype=dtype)
        else:
            self.conv = ConvBN(c, c, 3, 1, 1, groups=c, dtype=dtype)
            self.conv1 = Conv(c, c, 1, groups=c, bias=True, dtype=dtype)
            self.bn = BatchNorm(c, 1e-5, dtype=dtype)

    def forward(self, x):
        if self.deploy:
            return self.fused(x)
        return self.bn(self.conv(x) + self.conv1(x) + x)


class RepViTBlock(nn.Module):
    """Token mixer + residual channel mixer."""

    def __init__(self, in_features: int, out_channels: int, stride: int, use_se: bool,
                 deploy: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = in_features
        self.stride = stride
        if stride == 2:
            self.tm_dw = ConvBN(c, c, 3, 2, 1, groups=c, deploy=deploy, dtype=dtype)
            self.tm_se = SqueezeExcite(c, dtype=dtype) if use_se else None
            self.tm_pw = ConvBN(c, out_channels, 1, deploy=deploy, dtype=dtype)
            mix = out_channels
        else:
            self.tm_repvgg = RepVGGDW(c, deploy=deploy, dtype=dtype)
            self.tm_se = SqueezeExcite(c, dtype=dtype) if use_se else None
            mix = c
        self.cm_expand = ConvBN(mix, 2 * out_channels, 1, deploy=deploy, dtype=dtype)
        self.cm_project = ConvBN(2 * out_channels, out_channels, 1, deploy=deploy, dtype=dtype)

    def forward(self, x):
        if self.stride == 2:
            y = self.tm_dw(x)
            if self.tm_se is not None:
                y = self.tm_se(y)
            y = self.tm_pw(y)
        else:
            y = self.tm_repvgg(x)
            if self.tm_se is not None:
                y = self.tm_se(y)
        return y + self.cm_project(gelu_exact(self.cm_expand(y)))


class RepViT(nn.Module):
    """Feature trunk: returns the stride-32 final map, NHWC. cfgs rows:
    (channels, use_se, stride); kernel 3 and expansion 2x throughout."""

    def __init__(self, cfgs: Sequence[tuple], deploy: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfgs = tuple(tuple(c) for c in cfgs)
        c0 = self.cfgs[0][0]
        self.patch_embed = nn.ModuleList([
            ConvBN(3, c0 // 2, 3, 2, 1, deploy=deploy, dtype=dtype),
            ConvBN(c0 // 2, c0, 3, 2, 1, deploy=deploy, dtype=dtype)])
        blocks, cin = [], c0
        for c, use_se, s in self.cfgs:
            oc = make_divisible(c, 8)
            blocks.append(RepViTBlock(cin, oc, s, bool(use_se), deploy=deploy, dtype=dtype))
            cin = oc
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = cin

    def forward(self, x):
        x = self.patch_embed[1](gelu_exact(self.patch_embed[0](x)))
        for blk in self.blocks:
            x = blk(x)
        return x


def _m0_9_cfgs():
    return (
        [(48, 1, 1), (48, 0, 1), (48, 0, 1), (96, 0, 2)]
        + [(96, 1, 1), (96, 0, 1), (96, 0, 1), (192, 0, 2)]
        + [(192, se, 1) for se in (1, 0) * 7] + [(192, 0, 1)]
        + [(384, 0, 2), (384, 1, 1), (384, 0, 1)]
    )


def _m1_1_cfgs():
    return (
        [(64, 1, 1), (64, 0, 1), (64, 0, 1), (128, 0, 2)]
        + [(128, 1, 1), (128, 0, 1), (128, 0, 1), (256, 0, 2)]
        + [(256, se, 1) for se in (1, 0) * 6] + [(256, 0, 1)]
        + [(512, 0, 2), (512, 1, 1), (512, 0, 1)]
    )


def _m2_3_cfgs():
    return (
        [(80, 1, 1), (80, 0, 1), (80, 1, 1), (80, 0, 1), (80, 1, 1), (80, 0, 1),
         (80, 0, 1), (160, 0, 2)]
        + [(160, 1, 1), (160, 0, 1), (160, 1, 1), (160, 0, 1), (160, 1, 1),
           (160, 0, 1), (160, 0, 1), (320, 0, 2)]
        + [(320, se, 1) for se in (1, 0) * 17] + [(320, 0, 1)]
        + [(640, 0, 2), (640, 1, 1), (640, 0, 1)]
    )


def repvit_m0_9(**kw):
    return RepViT(_m0_9_cfgs(), **kw)


def repvit_m1_1(**kw):
    return RepViT(_m1_1_cfgs(), **kw)


def repvit_m2_3(**kw):
    return RepViT(_m2_3_cfgs(), **kw)


REPVIT_VARIANTS = {
    "m0.9": repvit_m0_9, "m0_9": repvit_m0_9,
    "m1.1": repvit_m1_1, "m1_1": repvit_m1_1,
    "m2.3": repvit_m2_3, "m2_3": repvit_m2_3,
}
REPVIT_OUT_CHANNELS = {
    "m0.9": 384, "m0_9": 384, "m1.1": 512, "m1_1": 512, "m2.3": 640, "m2_3": 640,
}


def _fold_bn(sd, prefix, eps=1e-5):
    """(scale, shift) of the eval-mode BatchNorm at ``prefix``: y = x scale + shift."""
    scale = sd[f"{prefix}.weight"] / torch.sqrt(sd[f"{prefix}.running_var"] + eps)
    return scale, sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * scale


def _fuse_conv_bn(sd, prefix):
    """The ConvBN at ``prefix`` as (weight, bias) of one conv."""
    scale, shift = _fold_bn(sd, f"{prefix}.bn")
    return sd[f"{prefix}.c.weight"] * scale[:, None, None, None], shift


def fuse_repvit_state_dict(state_dict, cfgs) -> dict:
    """Train-form RepViT state_dict -> the state_dict of ``RepViT(cfgs,
    deploy=True)``: every Conv+BN folds into one biased conv; the RepVGG
    mixer (dw3x3+BN, dw1x1, identity) sums into one dw3x3 kernel, and its
    outer BN folds on top. The fold runs in fp32 and returns fp32 tensors."""
    sd = {k: v.detach().float() for k, v in state_dict.items()}
    out = {}

    def put_conv_bn(src, dst):
        w, b = _fuse_conv_bn(sd, src)
        out[f"{dst}.c.weight"], out[f"{dst}.c.bias"] = w, b

    put_conv_bn("patch_embed.0", "patch_embed.0")
    put_conv_bn("patch_embed.1", "patch_embed.1")
    for i, (_, use_se, s) in enumerate(cfgs):
        p = f"blocks.{i}"
        if s == 2:
            put_conv_bn(f"{p}.tm_dw", f"{p}.tm_dw")
            put_conv_bn(f"{p}.tm_pw", f"{p}.tm_pw")
        else:
            r = f"{p}.tm_repvgg"
            k3, b3 = _fuse_conv_bn(sd, f"{r}.conv")  # (C, 1, 3, 3)
            k = k3.clone()
            k[:, :, 1, 1] += sd[f"{r}.conv1.weight"][:, :, 0, 0] + 1.0  # dw1x1 and identity
            b = b3 + sd[f"{r}.conv1.bias"]
            scale, shift = _fold_bn(sd, f"{r}.bn")
            out[f"{r}.fused.weight"] = k * scale[:, None, None, None]
            out[f"{r}.fused.bias"] = b * scale + shift
        if use_se:
            for leaf in ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"):
                out[f"{p}.tm_se.{leaf}"] = sd[f"{p}.tm_se.{leaf}"]
        put_conv_bn(f"{p}.cm_expand", f"{p}.cm_expand")
        put_conv_bn(f"{p}.cm_project", f"{p}.cm_project")
    return out


def fuse_repvit_params(params: dict, stats: dict, cfgs) -> dict:
    """Train-form RepViT parameters and BatchNorm statistics (the port's
    names, as ``named_parameters`` and ``named_buffers`` give them) -> the
    deploy-form state_dict (``fuse_repvit_state_dict`` of the two)."""
    return fuse_repvit_state_dict({**params, **stats}, cfgs)
