"""Tracker memory attention: image tokens cross-attend the memory bank.

Counterpart of efficientsam3_tpu/models/memory_attention.py: 4 pre-norm
layers at d_model 256, a single-head RoPE self-attention over the 72x72
image tokens and a RoPE cross-attention (kv_in_dim 64, rope_k_repeat) to
the [spatial memories ; object-pointer tokens] bank, 0.1x positional
encoding added at the input, a final LayerNorm. The 13 norms run on the
``layer_norm`` kernel; on CUDA the self-attention and the plain path's
cross-attention run on ``flash_sdpa`` at head dim 256.

Training mode (the module's ``.train()``, the JAX ``train=True``): dropout
(0.1) after the self-attention, after the cross-attention, and twice in the
FFN tail (after the activation and after the second projection), on both
``forward`` and ``forward_cached``; torch draws the bits (seed them with
``torch.manual_seed``). Under autograd on CUDA the plain path runs the
backward kernels of ``flash_sdpa`` and ``layer_norm``; the cached path's
``flash_memattn`` / ``flash_memattn_q8`` are forward-only (as in JAX) and
raise.

The memory bank has a fixed width with invalid entries masked. An object
slot whose memory is all masked is empty padding: its self-attention keys
are masked too, so the flash kernel skips its tiles and the per-frame cost
follows the active objects (such a slot's rows come out 0 from the kernel
and as a uniform average from the CPU's matmul path; callers gate them).

Cached path (``forward_cached`` / ``project_bank_entry``): each bank
entry's per-layer keys are projected and rotated once, when the entry is
encoded; per frame only the queries and the object-pointer tokens are
projected. Values are never projected per key: v_proj is linear and
softmax rows sum to 1, so attention runs over the raw 64-wide memory
tokens (``flash_memattn`` on CUDA) and v_proj applies once per query.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    ACT,
    Dense,
    FusedLayerNorm,
    RoPEAttention,
    dropout,
)


class MemoryAttentionLayer(nn.Module):
    """self RoPE-attn -> cross RoPE-attn to memory -> FFN."""

    def __init__(self, d_model: int = 256, dim_feedforward: int = 2048, num_heads: int = 1,
                 kv_in_dim: int = 64, dropout: float = 0.1, activation: str = "relu",
                 pos_enc_at_cross_attn_keys: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.pos_enc_at_cross_attn_keys = pos_enc_at_cross_attn_keys
        self.activation = ACT[activation]
        self.norm1 = FusedLayerNorm(d_model, 1e-5, dtype=dtype)
        self.norm2 = FusedLayerNorm(d_model, 1e-5, dtype=dtype)
        self.norm3 = FusedLayerNorm(d_model, 1e-5, dtype=dtype)
        self.self_attn = RoPEAttention(d_model, num_heads, dtype=dtype)
        self.cross_attn_image = RoPEAttention(d_model, num_heads, kv_in_dim=kv_in_dim,
                                              rope_k_repeat=True, dtype=dtype)
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)

    def _cross_keys(self, memory, memory_pos):
        return memory + memory_pos if self.pos_enc_at_cross_attn_keys else memory

    def project_entry_k(self, entry, entry_pos, grid_tokens: int):
        """Cached keys of one bank entry (B, S, kv_in_dim); entry_pos holds
        the spatial sine embedding only (the slot-age embedding is added
        later as a rotated linear delta)."""
        return self.cross_attn_image.project_k(self._cross_keys(entry, entry_pos), grid_tokens)

    def _drop(self, x):
        return dropout(x, self.dropout, self.training)

    def _self_block(self, tgt, self_key_padding_mask):
        t2 = self.norm1(tgt)
        return tgt + self._drop(self.self_attn(t2, t2, t2, key_padding_mask=self_key_padding_mask))

    def _tail(self, tgt):
        t2 = self.linear1(self.norm3(tgt))
        return tgt + self._drop(self.linear2(self._drop(self.activation(t2))))

    def forward(self, tgt, memory, memory_pos, memory_mask=None, num_obj_ptr_tokens: int = 0,
                self_key_padding_mask=None):
        """tgt (B, HW, C); memory / memory_pos (B, S, kv_in_dim); masks True
        = invalid."""
        tgt = self._self_block(tgt, self_key_padding_mask)
        t2 = self.cross_attn_image(self.norm2(tgt), self._cross_keys(memory, memory_pos), memory,
                                   num_k_exclude_rope=num_obj_ptr_tokens,
                                   key_padding_mask=memory_mask)
        return self._tail(tgt + self._drop(t2))

    def forward_cached(self, tgt, kh_mem, v_mem, mem_mask, kh_ptr, v_ptr, ptr_mask,
                       self_key_padding_mask=None):
        """kh_mem (B, 1, S_mem, C) cached keys; v_mem (B, 1, S_mem, kv_in_dim)
        raw bank tokens; kh_ptr / v_ptr the frame's pointer tokens."""
        tgt = self._self_block(tgt, self_key_padding_mask)
        t2 = self.cross_attn_image.attend_projected_rawv_2seg(
            self.norm2(tgt), kh_mem, v_mem, mem_mask, kh_ptr, v_ptr, ptr_mask)
        return self._tail(tgt + self._drop(t2))


class MemoryAttention(nn.Module):
    """The 4-layer memory-attention encoder."""

    def __init__(self, num_layers: int = 4, d_model: int = 256, kv_in_dim: int = 64,
                 dim_feedforward: int = 2048, pos_enc_at_input: bool = True,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pos_enc_at_input = pos_enc_at_input
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(d_model, dim_feedforward, kv_in_dim=kv_in_dim, dropout=dropout,
                                 dtype=dtype)
            for _ in range(num_layers))
        self.norm = FusedLayerNorm(d_model, 1e-5)

    def _prep(self, src, src_pos, memory_mask):
        if src_pos is not None and src_pos.ndim == 2:
            src_pos = src_pos[None].expand(src.shape)
        out = src
        if self.pos_enc_at_input and src_pos is not None:
            out = out + 0.1 * src_pos
        self_kpm = None
        if memory_mask is not None:
            # an object slot with no valid memory token is empty padding
            self_kpm = memory_mask.all(-1)[:, None].expand(src.shape[0], src.shape[1])
        return out, self_kpm

    def forward(self, src, src_pos, memory, memory_pos, memory_mask=None,
                num_obj_ptr_tokens: int = 0):
        out, self_kpm = self._prep(src, src_pos, memory_mask)
        for layer in self.layers:
            out = layer(out, memory, memory_pos, memory_mask, num_obj_ptr_tokens, self_kpm)
        return self.norm(out)

    def project_bank_entry(self, entry, entry_pos, grid_tokens: int):
        """All layers' cached keys of one bank entry: (L, B, heads, S, C),
        layer axis first so that a layer's bank slice is a view."""
        if entry_pos.ndim == 2:
            entry_pos = entry_pos[None]
        return torch.stack([layer.project_entry_k(entry, entry_pos, grid_tokens)
                            for layer in self.layers])

    def forward_cached(self, src, src_pos, k_mem_layers, v_mem, mem_mask, k_ptr_layers, v_ptr,
                       ptr_mask):
        out, self_kpm = self._prep(src, src_pos, torch.cat([mem_mask, ptr_mask], dim=1))
        for layer, kh_mem, kh_ptr in zip(self.layers, k_mem_layers, k_ptr_layers):
            out = layer.forward_cached(out, kh_mem, v_mem, mem_mask, kh_ptr, v_ptr, ptr_mask,
                                       self_kpm)
        return self.norm(out)
