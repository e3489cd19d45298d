"""Shared nn primitives, (B, N, C) tokens and NHWC maps.

Counterpart of efficientsam3_tpu/models/common.py. The first block holds
torch equivalents of the flax layers the JAX package builds on (Dense,
Conv, BatchNorm, LayerNorm, GroupNorm, Embed) with flax's dtype rules: a
layer with ``dtype`` set computes and returns that dtype (its parameters
are stored in it, which is what flax's per-call cast gives numerically);
a layer without one computes in the promotion of the input and fp32
parameters. Parameter names follow the flax tree so that
``utils/convert.py`` is a rule-based walk.

Attention: ``sdpa`` keeps the JAX routing rules: large attentions with no
full bias and at most a key-padding mask go to the flash kernel
(``ops/flash_attention.flash_sdpa``) when the tensors are on CUDA; the
rest runs as matmul + fp32 softmax + P cast to v's dtype, like the JAX
einsum branch. ``MultiheadAttention(rpb=...)`` sends the decoder's boxRPB
cross-attention to ``flash_xattn_rpb`` on CUDA.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.ops.flash_attention import NEG_INF, flash_sdpa, flash_xattn_rpb
from efficientsam3_tpu_torch.ops.layer_norm import layer_norm


def _cdtype(x, dtype):
    """flax's compute dtype: the layer's dtype, else promote(x, float32)."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


def _pdtype(dtype):
    return dtype if dtype is not None else torch.float32


# --------------------------------------------------------------------------
# flax layer equivalents
# --------------------------------------------------------------------------


class Dense(nn.Module):
    """flax nn.Dense: y = x W^T + b over the last axis."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=_pdtype(dtype)))
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=_pdtype(dtype))) if bias else None
        )

    def forward(self, x):
        dt = _cdtype(x, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Module):
    """flax nn.Conv over NHWC maps (run as NCHW views by F.conv2d).

    padding: an int or (ph, pw) pair, symmetric per axis, or "VALID".
    """

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Union[int, Sequence[int]], stride: int = 1,
                 padding: Union[int, Sequence[int], str] = 0, groups: int = 1,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.dtype = dtype
        self.stride = stride
        self.padding = 0 if padding == "VALID" else padding
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features // groups, kh, kw, dtype=_pdtype(dtype))
        )
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=_pdtype(dtype))) if bias else None
        )

    def forward(self, x):
        dt = _cdtype(x, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     self.stride, self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm at inference (running statistics), NHWC or (B, L, C).

    Statistics and parameters stay fp32; the result is cast to ``dtype``.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        dt = _cdtype(x, self.dtype)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(dt)


def _fast_stats(xf, dims):
    """flax's default statistics: mean and max(E[x^2] - E[x]^2, 0)."""
    mean = xf.mean(dims, keepdim=True)
    mean2 = (xf * xf).mean(dims, keepdim=True)
    return mean, (mean2 - mean * mean).clamp_min(0.0)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis (fp32 statistics)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        dt = _cdtype(x, self.dtype)
        xf = x.float()
        mean, var = _fast_stats(xf, -1)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(dt)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm over NHWC maps (fp32 statistics)."""

    def __init__(self, num_groups: int, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        dt = _cdtype(x, self.dtype)
        b, h, w, c = x.shape
        xg = x.float().reshape(b, h * w, self.num_groups, c // self.num_groups)
        mean, var = _fast_stats(xg, (1, 3))
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        return (y * self.weight + self.bias).to(dt)


class Embed(nn.Module):
    """flax nn.Embed: a (num, dim) fp32 table."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, idx):
        return F.embedding(idx.long(), self.weight)


# --------------------------------------------------------------------------
# counterparts of models/common.py
# --------------------------------------------------------------------------


def gelu_exact(x):
    """erf-form GELU (torch nn.GELU default)."""
    return F.gelu(x)


class ConvTranspose2x(nn.Module):
    """2x2-stride-2 transposed conv as one product + depth-to-space.

    ``weight`` is (out, in, 2, 2), the flax kernel (2, 2, in, out) carried
    over by the conv rule; flax reaches tap (1 - i, 1 - j) for output
    offset (i, j), so out[2h+i, 2w+j, o] = sum_c x[h, w, c] W[o, c, 1-i, 1-j].
    """

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 2, 2, dtype=_pdtype(dtype)))
        self.bias = nn.Parameter(torch.zeros(features, dtype=_pdtype(dtype)))

    def forward(self, x):
        dt = _cdtype(x, self.dtype)
        b, h, w, c = x.shape
        o = self.weight.shape[0]
        k = self.weight.to(dt).flip(2, 3).permute(1, 2, 3, 0).reshape(c, 4 * o)
        y = torch.matmul(x.to(dt).reshape(b * h * w, c), k).reshape(b, h, w, 2, 2, o)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, o)
        return y + self.bias.to(dt)


class FusedLayerNorm(nn.Module):
    """LayerNorm on the ``ops.layer_norm`` kernel (flax FusedLayerNorm).

    fp32 statistics, biased two-pass variance, eps inside the sqrt.
    ``dtype`` sets the OUTPUT dtype only (default: promote(x, float32)).
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        out_dtype = _cdtype(x, self.dtype)
        return layer_norm(x, self.weight, self.bias, self.eps, out_dtype)


class MLP(nn.Module):
    """Detectron-style MLP (inference): ReLU between layers, optional
    residual and output LayerNorm."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 residual: bool = False, out_norm: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(i, o, dtype=dtype) for i, o in zip(dims_in, dims_out)
        )
        self.residual = residual
        self.out_norm_ln = LayerNorm(output_dim, 1e-5, dtype=dtype) if out_norm else None

    def forward(self, x):
        inp = x
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        if self.residual:
            x = x + inp
        if self.out_norm_ln is not None:
            x = self.out_norm_ln(x)
        return x


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NHWC input (eps 1e-6, two-pass variance)."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        xf = x.float()
        u = xf.mean(-1, keepdim=True)
        s = (xf - u).square().mean(-1, keepdim=True)
        xf = (xf - u) * torch.rsqrt(s + self.eps)
        return (self.weight * xf + self.bias).to(x.dtype)


# Large attentions route to the flash kernel; the (Lq, Lk) threshold keeps
# small ones (decoder queries, text towers, prompt tokens) on the matmul
# path, as in the JAX package.
_FLASH_MIN_SCORES = 1 << 22


def _flash_eligible(q, k, mask, bias):
    if bias is not None:  # full (Lq, Lk) biases stay on the matmul path
        return False
    if q.ndim != 4 or q.shape[-2] * k.shape[-2] < _FLASH_MIN_SCORES:
        return False
    if mask is not None and (mask.ndim != 4 or mask.shape[1] != 1 or mask.shape[2] != 1):
        return False  # only key-padding masks map to the kernel's key bias
    return q.is_cuda


def sdpa(q, k, v, mask=None, bias=None):
    """Scaled dot-product attention over (B, H, N, D) with fp32 softmax.

    mask: bool, True = attend. bias: additive logits bias.
    """
    d = q.shape[-1]
    if _flash_eligible(q, k, mask, bias):
        b, lk = q.shape[0], k.shape[-2]
        if mask is None:
            key_bias = torch.zeros((b, lk), dtype=torch.float32, device=q.device)
        else:
            key_bias = torch.where(mask[:, 0, 0, :], 0.0, NEG_INF)
        return flash_sdpa(q, k, v, key_bias, 1.0 / math.sqrt(d))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def split_heads(x, num_heads: int):
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class MultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention-parity module (batch-first, same dims),
    with separate q/k/v/out projections as in the flax tree."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.out_proj = Dense(embed_dim, embed_dim, dtype=dtype)

    def forward(self, q, k, v, key_padding_mask=None, rpb=None):
        """key_padding_mask: (B, Nk) bool, True = PAD. rpb: the decomposed
        boxRPB bias (ey, ex, (h, w)); on CUDA it runs on the flash_xattn_rpb
        kernel (inference: the port has no backward), otherwise the full
        bias is built for the matmul path."""
        qh = split_heads(self.q_proj(q), self.num_heads)
        kh = split_heads(self.k_proj(k), self.num_heads)
        vh = split_heads(self.v_proj(v), self.num_heads)
        mask = None if key_padding_mask is None else ~key_padding_mask[:, None, None, :]
        bias = None
        if rpb is not None:
            if key_padding_mask is not None:
                raise ValueError("rpb attention takes no key padding mask")
            ey, ex, feat_hw = rpb
            if qh.is_cuda:
                out = flash_xattn_rpb(qh, kh, vh, ey, ex, feat_hw,
                                      1.0 / math.sqrt(qh.shape[-1]))
                return self.out_proj(merge_heads(out))
            bias = (ey[..., :, None] + ex[..., None, :]).reshape(
                *ey.shape[:3], feat_hw[0] * feat_hw[1])
        out = sdpa(qh, kh, vh, mask=mask, bias=bias)
        return self.out_proj(merge_heads(out))


# --------------------------------------------------------------------------
# Position embeddings
# --------------------------------------------------------------------------


def _dim_t(npf: int, temperature: float, device):
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / npf)


def _interleave_sin_cos(p):
    """stack([sin(p[..., 0::2]), cos(p[..., 1::2])], -1).reshape(..., n)."""
    out = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1)
    return out.reshape(*p.shape[:-1], -1)


def sine_pos_embed_2d(h: int, w: int, num_pos_feats: int = 256, device=None):
    """(H, W, num_pos_feats) normalized sine embedding (JAX sine_pos_embed_2d,
    temperature 10000, scale 2 pi)."""
    npf = num_pos_feats // 2
    scale, eps = 2 * math.pi, 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = _dim_t(npf, 10000.0, device)
    pos_x = _interleave_sin_cos(x[:, :, None] / dim_t)
    pos_y = _interleave_sin_cos(y[:, :, None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_encode_xy(x, y, num_pos_feats: int = 256):
    """1D sine encodings of normalized coords -> (pos_x, pos_y), each (..., npf)."""
    npf = num_pos_feats // 2
    scale = 2 * math.pi
    dim_t = _dim_t(npf, 10000.0, x.device)
    px = _interleave_sin_cos((x * scale)[..., None] / dim_t)
    py = _interleave_sin_cos((y * scale)[..., None] / dim_t)
    return px, py


def sine_encode_boxes(x, y, w, h, num_pos_feats: int = 256):
    """(..., 2*npf + 2) box encoding."""
    px, py = sine_encode_xy(x, y, num_pos_feats)
    return torch.cat([py, px, h[..., None], w[..., None]], dim=-1)
