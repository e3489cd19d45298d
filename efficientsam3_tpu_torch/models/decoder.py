"""DETR-style transformer decoder with box refinement, boxRPB attention
bias and a presence token; dot-product scoring.

Counterpart of efficientsam3_tpu/models/decoder.py: 6 layers, 200
queries, d_model 256, ff 2048, 8 heads, text cross-attention, box
refinement, boxRPB "log", presence token. DAC (duplicated o2o + o2m
queries) runs only when asked (``apply_dac``): the image model asks in
training, as the JAX model does. The boxRPB bias is kept decomposed as
(ey, ex); on CUDA where autograd records nothing the image
cross-attention rebuilds it per tile in the flash_xattn_rpb kernel; a call
that needs a gradient (training, or eval-mode heads that pass gradient to
the trunk, as the geometry finetune runs them) takes the full bias on the
matmul path (the kernel is forward-only). Training mode also applies
dropout (0.1) where the JAX layers do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    MLP,
    Dense,
    Embed,
    LayerNorm,
    MultiheadAttention,
    dropout,
)


def inverse_sigmoid(x, eps: float = 1e-3):
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp_min(eps)
    x2 = (1.0 - x).clamp_min(eps)
    return torch.log(x1 / x2)


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b):
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def gen_sineembed_for_position(pos, num_feats: int = 256):
    """(..., 2|4) normalized coords -> sine features, order y, x(, w, h)."""
    half = num_feats // 2
    scale = 2 * math.pi
    dim_t = torch.arange(half, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)

    def enc(v):
        p = (v * scale)[..., None] / dim_t
        out = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1)
        return out.reshape(*v.shape, half)

    pos_x = enc(pos[..., 0])
    pos_y = enc(pos[..., 1])
    if pos.shape[-1] == 2:
        return torch.cat([pos_y, pos_x], dim=-1)
    return torch.cat([pos_y, pos_x, enc(pos[..., 2]), enc(pos[..., 3])], dim=-1)


class DecoderLayer(nn.Module):
    """Self-attn (queries + presence) -> text cross-attn -> image
    cross-attn with boxRPB bias -> FFN (fp32)."""

    def __init__(self, d_model: int = 256, dim_feedforward: int = 2048, num_heads: int = 8,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(d_model, 1e-5)
        self.ca_text = MultiheadAttention(d_model, num_heads, dtype=dtype)
        self.catext_norm = LayerNorm(d_model, 1e-5)
        self.cross_attn = MultiheadAttention(d_model, num_heads, dtype=dtype)
        self.norm1 = LayerNorm(d_model, 1e-5)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm3 = LayerNorm(d_model, 1e-5)

    def forward(self, tgt, query_pos, memory, memory_pos, rpb, memory_text=None,
                text_key_padding_mask=None, presence_token=None, dac: bool = False):
        p, train = self.dropout, self.training
        nq = tgt.shape[1]
        if dac:
            q_half = nq // 2
            tgt_o2o, pos_o2o, tgt_o2m = tgt[:, :q_half], query_pos[:, :q_half], tgt[:, q_half:]
        else:
            tgt_o2o, pos_o2o, tgt_o2m = tgt, query_pos, None
        if presence_token is not None:
            zeros = torch.zeros_like(presence_token)
            tgt_o2o = torch.cat([presence_token, tgt_o2o], dim=1)
            pos_o2o = torch.cat([zeros.to(pos_o2o.dtype), pos_o2o], dim=1)
            query_pos_full = torch.cat([zeros.to(query_pos.dtype), query_pos], dim=1)
        else:
            query_pos_full = query_pos
        qk = tgt_o2o + pos_o2o
        tgt_o2o = tgt_o2o + dropout(self.self_attn(qk, qk, tgt_o2o), p, train)
        tgt = torch.cat([tgt_o2o, tgt_o2m], dim=1) if dac else tgt_o2o
        tgt = self.norm2(tgt)

        if memory_text is not None:
            t2 = self.ca_text(tgt + query_pos_full, memory_text, memory_text,
                              key_padding_mask=text_key_padding_mask)
            tgt = self.catext_norm(tgt + dropout(t2, p, train))

        k = memory + memory_pos if memory_pos is not None else memory
        t2 = self.cross_attn(tgt + query_pos_full, k, memory, rpb=rpb)
        tgt = self.norm1(tgt + dropout(t2, p, train))

        t2 = self.linear2(dropout(F.relu(self.linear1(tgt.float())), p, train))
        tgt = self.norm3(tgt + dropout(t2.to(tgt.dtype), p, train))
        if presence_token is not None:
            return tgt[:, 1:], tgt[:, :1]
        return tgt, None


class TransformerDecoder(nn.Module):
    """The image model's decoder: boxRPB "log" and the presence token."""

    def __init__(self, num_layers: int = 6, num_queries: int = 200, d_model: int = 256,
                 dim_feedforward: int = 2048, num_heads: int = 8, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = d_model
        self.num_queries = num_queries
        self.d_model = d
        self.query_embed = Embed(num_queries, d)
        self.reference_points = Embed(num_queries, 4)
        self.norm = LayerNorm(d, 1e-5)
        self.bbox_embed = MLP(d, d, 4, 3)
        self.ref_point_head = MLP(2 * d, d, d, 2)
        self.boxRPB_embed_x = MLP(2, d, num_heads, 2)
        self.boxRPB_embed_y = MLP(2, d, num_heads, 2)
        self.presence_token_embed = Embed(1, d)
        self.presence_token_head = MLP(d, d, 1, 3)
        self.presence_token_out_norm = LayerNorm(d, 1e-5)
        self.layers = nn.ModuleList(
            DecoderLayer(d, dim_feedforward, num_heads, dropout, dtype=dtype)
            for _ in range(num_layers)
        )

    def _rpb_decomposed(self, reference_boxes, feat_hw):
        """(B, NQ, 4) cxcywh -> (ey (B, nh, NQ, H), ex (B, nh, NQ, W))."""
        h, w = feat_hw
        dev = reference_boxes.device
        boxes = box_cxcywh_to_xyxy(reference_boxes)
        coords_h = torch.arange(h, dtype=torch.float32, device=dev) / h
        coords_w = torch.arange(w, dtype=torch.float32, device=dev) / w
        dy = coords_h[None, None, :, None] - boxes[:, :, None, 1:4:2]  # (B,NQ,H,2)
        dx = coords_w[None, None, :, None] - boxes[:, :, None, 0:3:2]  # (B,NQ,W,2)

        def logmap(v):
            v = v * 8.0
            return torch.sign(v) * torch.log2(v.abs() + 1.0) / math.log2(8.0)

        ex = self.boxRPB_embed_x(logmap(dx))  # (B, NQ, W, heads)
        ey = self.boxRPB_embed_y(logmap(dy))
        return ey.permute(0, 3, 1, 2), ex.permute(0, 3, 1, 2)

    def forward(self, memory, feat_hw, memory_pos=None, memory_text=None,
                text_key_padding_mask=None, apply_dac: bool = False):
        """apply_dac duplicates the queries (o2o + o2m), as the JAX model
        does in training."""
        b = memory.shape[0]
        tgt = self.query_embed.weight[None].expand(b, self.num_queries, self.d_model)
        ref = torch.sigmoid(self.reference_points.weight)[None].expand(b, self.num_queries, 4)
        if apply_dac:
            tgt = torch.cat([tgt, tgt], dim=1)
            ref = torch.cat([ref, ref], dim=1)
        presence = self.presence_token_embed.weight[None].expand(b, 1, self.d_model)

        inter_hs, inter_refs, inter_presence = [], [ref], []
        output = tgt
        for li, layer in enumerate(self.layers):
            query_pos = self.ref_point_head(gen_sineembed_for_position(ref, self.d_model))
            ey, ex = self._rpb_decomposed(ref, feat_hw)
            # the presence token (query row 0) attends with zero bias
            ey = torch.cat([torch.zeros_like(ey[:, :, :1]), ey], dim=2)
            ex = torch.cat([torch.zeros_like(ex[:, :, :1]), ex], dim=2)
            output, presence = layer(
                output, query_pos, memory, memory_pos, (ey, ex, feat_hw),
                memory_text=memory_text, text_key_padding_mask=text_key_padding_mask,
                presence_token=presence, dac=apply_dac,
            )
            normed = self.norm(output)
            new_ref = torch.sigmoid(self.bbox_embed(normed) + inverse_sigmoid(ref))
            ref = new_ref.detach()
            if li != len(self.layers) - 1:
                inter_refs.append(new_ref)
            inter_hs.append(normed)
            inter_presence.append(
                self.presence_token_head(self.presence_token_out_norm(presence))[..., 0, 0]
            )
        return {
            "hs": torch.stack(inter_hs),  # (L, B, NQ, C)
            "references": torch.stack(inter_refs),  # (L, B, NQ, 4)
            "presence_logits": torch.stack(inter_presence),  # (L, B)
            "presence_feats": presence,
        }


class DotProductScoring(nn.Module):
    """Query-to-pooled-prompt dot-product logits: hs (L, B, NQ, C), prompt
    (B, T, C), prompt_mask (B, T) True = pad -> (L, B, NQ, 1)."""

    def __init__(self, d_model: int = 256, d_proj: int = 256, clamp_max_val: float = 12.0,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_proj = d_proj
        self.clamp_max_val = clamp_max_val
        self.prompt_mlp = MLP(d_model, 2048, d_model, 2, residual=True, out_norm=True,
                              dropout=dropout)
        self.prompt_proj = Dense(d_model, d_proj, dtype=dtype)
        self.hs_proj = Dense(d_model, d_proj, dtype=dtype)

    def forward(self, hs, prompt, prompt_mask):
        prompt = self.prompt_mlp(prompt)
        valid = (~prompt_mask).float()[..., None]
        num_valid = valid.sum(1).clamp_min(1.0)
        pooled = (prompt * valid).sum(1) / num_valid
        proj_prompt = self.prompt_proj(pooled)
        proj_hs = self.hs_proj(hs)
        scores = torch.einsum("lbqd,bd->lbq", proj_hs.float(), proj_prompt.float())
        scores = scores / math.sqrt(self.d_proj)
        scores = scores.clamp(-self.clamp_max_val, self.clamp_max_val)
        return scores[..., None].to(hs.dtype)
