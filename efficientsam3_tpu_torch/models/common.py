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
(``ops/flash_attention.flash_sdpa``) when the tensors are on CUDA and the
kernels take their head dim and dtype (``flash_eligible``); the rest runs as
matmul + fp32 softmax + P cast to v's dtype, like the JAX einsum branch
(JAX's Pallas kernel takes any head dim; the port's matmul path computes
the same function where its kernels do not). ``sdpa_rawv`` routes the
tracker's cached memory bank (raw 64-wide values) to ``flash_memattn`` by
the same rule, and to ``flash_memattn_q8`` when the keys come as an int8
(k_i8, k_scale) pair (the tracker's ``quantize_bank``).
``MultiheadAttention(rpb=...)`` sends the decoder's boxRPB cross-attention
to ``flash_xattn_rpb`` on CUDA where no gradient is recorded
(``xattn_rpb_takes_kernel``). ``Attention`` / ``RoPEAttention`` are the
SAM heads' and the tracker's attentions, with the cached-bank entry points
(``project_kv``, ``attend_projected``, ``attend_projected_rawv`` and
``attend_projected_rawv_2seg``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.ops import _build
from efficientsam3_tpu_torch.ops.flash_attention import (
    _MEMATTN_DIMS,
    _SUPPORTED_D,
    KERNEL_DTYPES,
    NEG_INF,
    flash_memattn,
    flash_memattn_q8,
    flash_sdpa,
    flash_xattn_rpb,
)
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
    """flax nn.BatchNorm (momentum 0.9) over the last axis, NHWC or (B, L, C).

    In eval mode it normalises with the running statistics. In training
    mode it normalises with the batch's fp32 statistics (flax's fast
    variance, max(E[x^2] - E[x]^2, 0), which is the biased one) and updates
    the running statistics as flax does: r = 0.9 r + 0.1 batch, the biased
    variance included (torch's nn.BatchNorm2d would update with the
    unbiased one). Parameters stay fp32; the result is cast to ``dtype``.
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
        xf = x.float()
        if self.training:
            mean, var = _fast_stats(xf, tuple(range(x.ndim - 1)))
            mean, var = mean.reshape(-1), var.reshape(-1)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
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


ACT = {"relu": F.relu, "gelu": gelu_exact}


def dropout(x, p: float, training: bool):
    """flax nn.Dropout: in training, zero with probability p and scale the
    rest by 1 / (1 - p); otherwise (or at p = 0) the identity. The random
    bits are torch's, not JAX's."""
    if not training or p == 0.0:
        return x
    return F.dropout(x, p, True)


class DropPath(nn.Module):
    """flax ``DropPath`` (stochastic depth per sample): in training mode at
    rate > 0 each sample of the batch is kept with probability 1 - rate and
    scaled by 1 / (1 - rate), or zeroed; in eval mode or at rate 0 the
    identity. The keep mask comes from the ``generator`` the caller passes
    (torch's bits, not JAX's); without one it raises ValueError, where flax
    raises InvalidRngError for the missing "dropout" stream. A caller that
    recomputes the branch (activation checkpointing) draws the mask once
    with ``mask`` and passes it in, so both passes drop the same samples."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def active(self) -> bool:
        return self.training and self.rate > 0.0

    def mask(self, x, generator: Optional[torch.Generator]):
        """The (B, 1, ..., 1) bool keep mask of x's batch, on x's device."""
        if generator is None:
            raise ValueError(f"DropPath at rate {self.rate} in training mode needs a "
                             "torch.Generator for its masks (flax: a 'dropout' rng)")
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u < 1.0 - self.rate).to(x.device)

    def forward(self, x, generator: Optional[torch.Generator] = None, mask=None):
        if not self.active():
            return x
        if mask is None:
            mask = self.mask(x, generator)
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


class MLP(nn.Module):
    """Detectron-style MLP: ReLU between layers (each followed by dropout
    in training when ``dropout`` > 0), optional residual, output LayerNorm
    and sigmoid."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 residual: bool = False, out_norm: bool = False, sigmoid_output: bool = False,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(i, o, dtype=dtype) for i, o in zip(dims_in, dims_out)
        )
        self.residual = residual
        self.out_norm_ln = LayerNorm(output_dim, 1e-5, dtype=dtype) if out_norm else None
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        inp = x
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = dropout(F.relu(x), self.dropout, self.training)
        if self.residual:
            x = x + inp
        if self.out_norm_ln is not None:
            x = self.out_norm_ln(x)
        if self.sigmoid_output:
            x = torch.sigmoid(x)
        return x


class MLPBlock(nn.Module):
    """lin1 -> activation -> lin2 (the SAM transformer's MLP)."""

    def __init__(self, dim: int, mlp_dim: int, activation=gelu_exact,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin1 = Dense(dim, mlp_dim, dtype=dtype)
        self.lin2 = Dense(mlp_dim, dim, dtype=dtype)
        self.activation = activation

    def forward(self, x):
        return self.lin2(self.activation(self.lin1(x)))


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


def flash_eligible(q_shape, k_shape, v_shape, dtypes, mask_shape=None, bias=False,
                   rawv=False):
    """Whether a CUDA attention of these shapes and float dtypes goes to a
    flash kernel (``flash_sdpa``; with rawv, values of their own width,
    ``flash_memattn`` or ``flash_memattn_q8``) rather than the matmul path.
    JAX's rule (a large (Lq, Lk), no full bias, at most a key-padding mask)
    and the kernels' own sets: float operands all bf16 or all fp32, head
    dims ``_SUPPORTED_D`` (q, k and v of one width), or (dk, dv) in
    ``_MEMATTN_DIMS``. A CPU tensor takes the matmul path whatever this
    says (``_use_flash``)."""
    if bias:  # full (Lq, Lk) biases stay on the matmul path
        return False
    if len(q_shape) != 4 or q_shape[-2] * k_shape[-2] < _FLASH_MIN_SCORES:
        return False
    if mask_shape is not None and (len(mask_shape) != 4 or mask_shape[1] != 1
                                   or mask_shape[2] != 1):
        return False  # only key-padding masks map to the kernel's key bias
    if len(set(dtypes)) != 1 or next(iter(dtypes)) not in KERNEL_DTYPES:
        return False
    if rawv:
        return (q_shape[-1], v_shape[-1]) in _MEMATTN_DIMS
    return q_shape[-1] in _SUPPORTED_D and k_shape[-1] == v_shape[-1] == q_shape[-1]


def _use_flash(q, k, v, mask, bias, rawv=False):
    """The flash kernel for this call: CUDA tensors and ``flash_eligible``
    (the float dtypes of q, k and v: int8 keys are the q8 bank's)."""
    dtypes = {t.dtype for t in (q, k, v) if t.is_floating_point()}
    return q.is_cuda and flash_eligible(q.shape, k.shape, v.shape, dtypes,
                                        None if mask is None else mask.shape,
                                        bias is not None, rawv)


def sdpa(q, k, v, mask=None, bias=None):
    """Scaled dot-product attention over (B, H, N, D) with fp32 softmax.

    mask: bool, True = attend. bias: additive logits bias.
    """
    d = q.shape[-1]
    if _use_flash(q, k, v, mask, bias):
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


def sdpa_rawv(q, k, v_raw, mask=None, return_lse=False):
    """Attention whose values are raw (pre-projection) narrow tokens.

    q/k (B, H, Lq/Lk, D); v_raw (B, H, Lk, dv). Returns (B, H, Lq, dv), and
    the (B, H, Lq) log-sum-exp with return_lse, so the caller can merge
    this segment with another (``merge_attention_segments``). Large shapes
    on CUDA at a (dk, dv) and dtype the kernel takes (``flash_eligible``) go
    to ``flash_memattn`` (a fully masked row: 0, lse -1e9); the rest runs
    the einsum path of the JAX package (-inf masking: a
    fully masked row gives 0 with lse -inf), whose P is normalised before
    the cast to v's dtype.

    k may be a (k_i8, k_scale) tuple from ``quantize_rows``, k_scale (B, 1,
    Lk, 1): the tracker's opt-in int8 memory bank. Large shapes on CUDA go
    to ``flash_memattn_q8``, which also rounds q to int8 per row; the
    einsum path dequantizes k and leaves q as it is, so the two differ by
    q's own int8 rounding (the JAX package's documented difference between
    its kernel and its fallback).
    """
    d = q.shape[-1]
    k_quant = isinstance(k, tuple)
    k_arr = k[0] if k_quant else k
    if _use_flash(q, k_arr, v_raw, mask, None, rawv=True):
        b, lk = q.shape[0], k_arr.shape[-2]
        if mask is None:
            key_bias = torch.zeros((b, lk), dtype=torch.float32, device=q.device)
        else:
            key_bias = torch.where(mask[:, 0, 0, :], 0.0, NEG_INF)
        if k_quant:
            k_i8, k_scale = k
            return flash_memattn_q8(q, k_i8, k_scale[:, 0, :, 0], v_raw, key_bias,
                                    1.0 / math.sqrt(d), return_lse=return_lse)
        return flash_memattn(q, k, v_raw, key_bias, 1.0 / math.sqrt(d), return_lse=return_lse)
    if k_quant:
        k = (k[0].float() * k[1]).to(q.dtype)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if mask is not None:
        logits = torch.where(mask, logits, -math.inf)
    m = logits.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - m_safe)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul((p / l.clamp_min(1e-30)).to(v_raw.dtype), v_raw)
    if return_lse:
        lse = torch.where(torch.isfinite(m[..., 0]),
                          m_safe[..., 0] + torch.log(l[..., 0].clamp_min(1e-30)), -math.inf)
        return out, lse
    return out


def merge_attention_segments(parts):
    """Combine attention outputs over disjoint key segments by their LSEs.

    parts: [(out (B, H, Lq, dv), lse (B, H, Lq)), ...]. Softmax over the
    union is the LSE-weighted average of the segments' outputs. A fully
    masked segment (lse -inf or -1e9) drops out; if every segment is
    masked the result is 0."""
    ls = torch.stack([l for _, l in parts])
    m = ls.amax(0)
    m_safe = torch.where(m > torch.finfo(torch.float32).min / 2, m, 0.0)
    ws = [torch.exp(l - m_safe)[..., None] for _, l in parts]
    den = sum(ws)
    num = sum(o.float() * w for (o, _), w in zip(parts, ws))
    return (num / den.clamp_min(1e-30)).to(parts[0][0].dtype)


def xattn_rpb_takes_kernel(is_cuda: bool, needs_grad: bool) -> bool:
    """Whether the decoder's boxRPB cross-attention runs on the
    forward-only flash_xattn_rpb kernel: only on CUDA and where autograd
    records nothing. A call whose inputs need a gradient takes the
    differentiable matmul path with the full bias, whatever the module's
    mode (JAX's forward-only kernel cannot be differentiated either)."""
    return is_cuda and not needs_grad


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

    def forward(self, q, k, v, key_padding_mask=None, rpb=None, attn_mask=None):
        """key_padding_mask: (B, Nk) bool, True = PAD. attn_mask: an
        additive float bias (..., Nq, Nk), or a bool mask with True =
        masked, combined with key_padding_mask (the teacher text tower's
        causal mask). rpb: the decomposed boxRPB bias (ey, ex, (h, w)),
        routed by ``xattn_rpb_takes_kernel``: on CUDA where autograd
        records nothing it runs on the flash_xattn_rpb kernel; otherwise
        (the CPU, or a call whose inputs need a gradient: training, and
        the geometry finetune's eval-mode heads, whose gradient reaches the
        trunk; the kernel is forward-only) the full bias is built for the
        matmul path."""
        qh = split_heads(self.q_proj(q), self.num_heads)
        kh = split_heads(self.k_proj(k), self.num_heads)
        vh = split_heads(self.v_proj(v), self.num_heads)
        if rpb is not None:
            if key_padding_mask is not None or attn_mask is not None:
                raise ValueError("rpb attention takes no other mask")
            ey, ex, feat_hw = rpb
            if xattn_rpb_takes_kernel(qh.is_cuda, _build.needs_grad(qh, kh, vh, ey, ex)):
                out = flash_xattn_rpb(qh, kh, vh, ey, ex, feat_hw,
                                      1.0 / math.sqrt(qh.shape[-1]))
                return self.out_proj(merge_heads(out))
            attn_mask = (ey[..., :, None] + ex[..., None, :]).reshape(
                *ey.shape[:3], feat_hw[0] * feat_hw[1])
        mask = None if key_padding_mask is None else ~key_padding_mask[:, None, None, :]
        bias = None
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                mask = ~attn_mask if mask is None else mask & ~attn_mask
            else:
                bias = attn_mask
        out = sdpa(qh, kh, vh, mask=mask, bias=bias)
        return self.out_proj(merge_heads(out))


class Attention(nn.Module):
    """SAM-style attention: separate q/k/v/out projections, an optional
    key/value input dim, internal dim embedding_dim // downsample_rate."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1,
                 kv_in_dim: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.internal_dim = embedding_dim // downsample_rate
        kv = kv_in_dim or embedding_dim
        self.q_proj = Dense(embedding_dim, self.internal_dim, dtype=dtype)
        self.k_proj = Dense(kv, self.internal_dim, dtype=dtype)
        self.v_proj = Dense(kv, self.internal_dim, dtype=dtype)
        self.out_proj = Dense(self.internal_dim, embedding_dim, dtype=dtype)

    def output(self, o):
        return self.out_proj(merge_heads(o))

    def forward(self, q, k, v):
        qh = split_heads(self.q_proj(q), self.num_heads)
        kh = split_heads(self.k_proj(k), self.num_heads)
        vh = split_heads(self.v_proj(v), self.num_heads)
        return self.output(sdpa(qh, kh, vh))


# --------------------------------------------------------------------------
# Rotary position encoding (axial 2D), real-valued
# --------------------------------------------------------------------------


def compute_axial_rope_cos_sin(dim: int, end_x: int, end_y: int, theta: float = 10000.0,
                               device=None, scale_pos: float = 1.0):
    """Axial rope tables (cos, sin), each (end_x * end_y, dim // 2): the
    first dim // 4 frequency slots encode x, the rest y. ``scale_pos``
    scales the positions (ViTDet's interpolation to its pretraining grid)."""
    quarter = dim // 4
    freqs = 1.0 / (theta ** (torch.arange(0, quarter, dtype=torch.float32, device=device)
                             * 4.0 / dim))
    t = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    t_x = (t % end_x) * scale_pos
    t_y = torch.floor(t / end_x) * scale_pos
    ang = torch.cat([torch.outer(t_x, freqs), torch.outer(t_y, freqs)], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate adjacent pairs of the last dim (torch view_as_complex order),
    in fp32; x (..., N, D), cos/sin (N, D // 2)."""
    x2 = x.float().reshape(*x.shape[:-1], -1, 2)
    a, b = x2[..., 0], x2[..., 1]
    out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class RoPEAttention(Attention):
    """Attention with axial rotary encoding on q and k.

    ``rope_k_repeat`` tiles the table along k's sequence (cross-attention
    to a bank of repeated spatial maps); ``num_k_exclude_rope`` leaves the
    trailing k tokens (object pointers) unrotated."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1,
                 kv_in_dim: Optional[int] = None, rope_theta: float = 10000.0,
                 rope_k_repeat: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(embedding_dim, num_heads, downsample_rate, kv_in_dim, dtype)
        self.rope_theta = rope_theta
        self.rope_k_repeat = rope_k_repeat
        self._tables = {}

    def _rope_tables(self, grid_tokens: int, device):
        key = (grid_tokens, str(device))
        if key not in self._tables:
            side = int(round(math.sqrt(grid_tokens)))
            self._tables[key] = compute_axial_rope_cos_sin(
                self.internal_dim // self.num_heads, side, side, self.rope_theta, device)
        return self._tables[key]

    def project_k(self, k, grid_tokens: int, num_k_exclude_rope: int = 0):
        """k projection + rotary encoding of the leading keys (the cached
        memory bank's keys are made by this once per entry)."""
        kh = split_heads(self.k_proj(k), self.num_heads)
        num_k_rope = kh.shape[-2] - num_k_exclude_rope
        if num_k_rope == 0:
            return kh
        cos, sin = self._rope_tables(grid_tokens, kh.device)
        if num_k_rope != grid_tokens:
            if not self.rope_k_repeat:
                raise ValueError("k/q length mismatch requires rope_k_repeat")
            r = num_k_rope // grid_tokens
            cos, sin = cos.repeat(r, 1), sin.repeat(r, 1)
        k_rope = apply_rope(kh[..., :num_k_rope, :], cos, sin)
        return torch.cat([k_rope, kh[..., num_k_rope:, :]], dim=-2)

    def project_kv(self, k, v, grid_tokens: int, num_k_exclude_rope: int = 0):
        """(rotated key heads, value heads), no attention."""
        return (self.project_k(k, grid_tokens, num_k_exclude_rope),
                split_heads(self.v_proj(v), self.num_heads))

    def _rope_q(self, q):
        qh = split_heads(self.q_proj(q), self.num_heads)
        cos, sin = self._rope_tables(qh.shape[-2], qh.device)
        return apply_rope(qh, cos, sin)

    def attend_projected(self, q, kh, vh, key_padding_mask=None):
        """Query projection + rope + attention over projected k/v heads.
        key_padding_mask (B, Lk): True = PAD."""
        mask = None if key_padding_mask is None else ~key_padding_mask[:, None, None, :]
        return self.output(sdpa(self._rope_q(q), kh, vh, mask=mask))

    def attend_projected_rawv(self, q, kh, v_raw, key_padding_mask=None):
        """Attention over projected keys and RAW (kv_in_dim) values: v_proj
        is linear and softmax rows sum to 1, so v_proj(A x) = A v_proj(x)
        and the up-projection runs once per query. Single head only."""
        if self.num_heads != 1:
            raise ValueError("the raw-value path needs a single head")
        mask = None if key_padding_mask is None else ~key_padding_mask[:, None, None, :]
        o = sdpa_rawv(self._rope_q(q), kh, v_raw, mask=mask)
        return self.out_proj(self.v_proj(merge_heads(o)))

    def attend_projected_rawv_2seg(self, q, kh_mem, v_mem, mem_mask, kh_ptr, v_ptr, ptr_mask):
        """attend_projected_rawv over two disjoint key segments, the cached
        memory bank and the object-pointer tokens, merged by log-sum-exp
        (exact) instead of concatenating the pointers onto the bank.
        kh_mem may be the bank's int8 (k_i8, k_scale) pair; the pointer
        segment stays in the compute dtype. Masks: True = PAD."""
        if self.num_heads != 1:
            raise ValueError("the raw-value path needs a single head")
        qh = self._rope_q(q)
        o1, l1 = sdpa_rawv(qh, kh_mem, v_mem, mask=~mem_mask[:, None, None, :], return_lse=True)
        o2, l2 = sdpa_rawv(qh, kh_ptr, v_ptr, mask=~ptr_mask[:, None, None, :], return_lse=True)
        o = merge_attention_segments([(o1, l1), (o2, l2)])
        return self.out_proj(self.v_proj(merge_heads(o)))

    def forward(self, q, k, v, num_k_exclude_rope: int = 0, key_padding_mask=None):
        kh, vh = self.project_kv(k, v, q.shape[-2], num_k_exclude_rope)
        return self.attend_projected(q, kh, vh, key_padding_mask)


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


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier point and grid encoding (SAM prompt encoder)."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.empty(2, num_pos_feats))

    def forward(self, coords):
        """coords (..., 2) in [0, 1] -> (..., 2 * num_pos_feats). The K = 2
        contraction is written out elementwise, as in the JAX package."""
        g = self.positional_encoding_gaussian_matrix
        c = 2.0 * coords.float() - 1.0
        c = 2.0 * math.pi * (c[..., 0:1] * g[0] + c[..., 1:2] * g[1])
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, h: int, w: int):
        """(H, W, C) encoding of the pixel-centre grid."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1)
        return self(grid)
