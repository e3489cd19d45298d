"""Fusion encoder: image tokens self-attend and cross-attend to the prompt.

Counterpart of efficientsam3_tpu/models/fusion_encoder.py: 6 pre-norm
layers, d_model 256, ff 2048, relu; self-attention with positional
encodings on q/k (the 5184-token attention runs on the flash_sdpa kernel
on CUDA, its backward too), cross-attention to the prompt tokens, FFN. The
three norms per layer run on the layer_norm kernel. In training mode each
residual branch and the FFN's hidden layer take dropout (0.1), as in JAX.
The JAX package rematerialises each layer in training (``nn.remat``); the
port keeps the activations (the card has the memory), so the forward
kernels run once per step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    Dense,
    FusedLayerNorm,
    MultiheadAttention,
    dropout,
)


class FusionEncoderLayer(nn.Module):
    """Pre-norm self-attn + cross-attn + FFN."""

    def __init__(self, d_model: int = 256, dim_feedforward: int = 2048, num_heads: int = 8,
                 pos_enc_at_attn: bool = True,
                 pos_enc_at_cross_attn_queries: bool = False,
                 pos_enc_at_cross_attn_keys: bool = False, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.pos_enc_at_attn = pos_enc_at_attn
        self.pos_enc_at_cross_attn_queries = pos_enc_at_cross_attn_queries
        self.pos_enc_at_cross_attn_keys = pos_enc_at_cross_attn_keys
        self.norm1 = FusedLayerNorm(d_model, 1e-5, dtype=dtype)
        self.self_attn = MultiheadAttention(d_model, num_heads, dtype=dtype)
        self.norm2 = FusedLayerNorm(d_model, 1e-5, dtype=dtype)
        self.cross_attn_image = MultiheadAttention(d_model, num_heads, dtype=dtype)
        self.norm3 = FusedLayerNorm(d_model, 1e-5, dtype=dtype)
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)

    def forward(self, tgt, memory, query_pos=None, pos=None,
                memory_key_padding_mask=None, tgt_key_padding_mask=None):
        """tgt (B, N, C) queries; memory (B, M, C); masks True = pad."""
        if self.dtype is not None and query_pos is not None:
            query_pos = query_pos.to(self.dtype)
        p, train = self.dropout, self.training
        t2 = self.norm1(tgt)
        qk = t2 + query_pos if (self.pos_enc_at_attn and query_pos is not None) else t2
        t2 = self.self_attn(qk, qk, t2, key_padding_mask=tgt_key_padding_mask)
        tgt = tgt + dropout(t2, p, train)

        t2 = self.norm2(tgt)
        q = t2 + query_pos if (self.pos_enc_at_cross_attn_queries and query_pos is not None) else t2
        k = memory + pos if (self.pos_enc_at_cross_attn_keys and pos is not None) else memory
        t2 = self.cross_attn_image(q, k, memory, key_padding_mask=memory_key_padding_mask)
        tgt = tgt + dropout(t2, p, train)

        t2 = self.norm3(tgt)
        t2 = self.linear2(dropout(F.relu(self.linear1(t2)), p, train))
        return tgt + dropout(t2, p, train)


class FusionEncoder(nn.Module):
    """Stack of FusionEncoderLayers over flattened single-level features."""

    def __init__(self, num_layers: int = 6, d_model: int = 256, dim_feedforward: int = 2048,
                 num_heads: int = 8, dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            FusionEncoderLayer(d_model, dim_feedforward, num_heads, dropout=dropout, dtype=dtype)
            for _ in range(num_layers)
        )

    def forward(self, src, pos, prompt, prompt_key_padding_mask=None):
        """src (B, N, C) image tokens; pos (B, N, C) or (N, C); prompt (B, M, C)."""
        if pos.ndim == 2:
            pos = pos[None].expand(src.shape)
        out = src
        for layer in self.layers:
            out = layer(out, prompt, query_pos=pos,
                        memory_key_padding_mask=prompt_key_padding_mask)
        return out
