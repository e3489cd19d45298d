"""SAM3 teacher text tower: a CLIP TextTransformer and its resizer.

Counterpart of efficientsam3_tpu/models/text_encoder.py: a 24-layer,
width-1024 CLIP-style causal transformer (pre-LN residual attention
blocks, exact GELU, MLP x4), ``ln_final``, then a linear ``resizer`` from
the width to d_model, with the pad mask ``tokens == 0``.

The norms are the port's plain ``LayerNorm`` (flax ``nn.LayerNorm``: fp32
statistics, the fast variance, eps 1e-5, fp32 out), as in JAX, where the
Pallas ``layer_norm`` serves only the fusion encoder. The causal mask is an
additive fp32 bias of ``finfo(float32).min`` above the diagonal; at the
contexts the model takes (at most 77) the attention runs as matmul + fp32
softmax (``common.sdpa``'s threshold), like the JAX einsums.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    Dense,
    Embed,
    LayerNorm,
    MultiheadAttention,
    gelu_exact,
)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + MLP. The flax names ``ln_1`` / ``ln_2`` walk to
    ``ln.1`` / ``ln.2`` (utils/convert.py), hence the ModuleDict."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln = nn.ModuleDict({"1": LayerNorm(width, 1e-5), "2": LayerNorm(width, 1e-5)})
        self.attn = MultiheadAttention(width, heads, dtype=dtype)
        self.c_fc = Dense(width, int(width * mlp_ratio), dtype=dtype)
        self.c_proj = Dense(int(width * mlp_ratio), width, dtype=dtype)

    def forward(self, x, attn_bias=None):
        h = self.ln["1"](x)
        x = x + self.attn(h, h, h, attn_mask=attn_bias)
        h = self.ln["2"](x)
        return x + self.c_proj(gelu_exact(self.c_fc(h)))


class TextTransformer(nn.Module):
    """CLIP text tower returning per-token features (pool_type 'none')."""

    def __init__(self, context_length: int = 32, vocab_size: int = 49408, width: int = 1024,
                 heads: int = 16, layers: int = 24, mlp_ratio: float = 4.0,
                 output_dim: int = 512, causal: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.causal = causal
        self.token_embedding = Embed(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, dtype=dtype) for _ in range(layers))
        self.ln_final = LayerNorm(width, 1e-5)
        # present in checkpoints, applied only to the pooled output, which the
        # SAM3 token path never reads
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, tokens):
        """tokens (B, L) int -> (B, L, width) final-LN token features."""
        seq = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:seq]
        bias = None
        if self.causal:
            neg = torch.finfo(torch.float32).min
            bias = torch.full((seq, seq), neg, device=x.device).triu(1)[None, None]
        for blk in self.resblocks:
            x = blk(x, attn_bias=bias)
        return self.ln_final(x)


class VETextEncoder(nn.Module):
    """Teacher text encoder: tokens -> (text_memory (B, L, d_model),
    pad_mask (B, L) True = pad)."""

    def __init__(self, d_model: int = 256, context_length: int = 32, width: int = 1024,
                 heads: int = 16, layers: int = 24, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = TextTransformer(context_length=context_length, width=width, heads=heads,
                                       layers=layers, dtype=dtype)
        self.resizer = Dense(width, d_model, dtype=dtype)

    def forward(self, tokens):
        return self.resizer(self.encoder(tokens)), tokens == 0
