"""MobileCLIP text towers (LiteText students), (B, L, D) tokens.

Counterpart of efficientsam3_tpu/models/mobile_clip.py: token embedding +
learnable positional embedding, then either
  - 'base': N pre-norm transformer layers (fp32 LayerNorm), causal for
    MobileCLIP-B (an additive fp32 finfo.min upper triangle on the fp32
    logits, before the softmax), or
  - 'mct': RepMixerBlock + N transformer layers + RepMixerBlock, RepMixer
    mixing tokens with (1, k) depthwise convs along the sequence axis,
a final fp32 LayerNorm, and a linear projector to d_model. The eight
towers of ``MOBILECLIP_TEXT_CFGS`` are the JAX table's.

The towers' attention is small (ctx 16/32/77), so it runs as matmul + fp32
softmax, like the JAX einsums: no kernel of the port's is on this path.
``truncate_pos_embed`` slices a tower's positional table to a shorter
context, as the JAX function does on its param tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    BatchNorm,
    Conv,
    Dense,
    Embed,
    LayerNorm,
    gelu_exact,
    merge_heads,
    split_heads,
)

MOBILECLIP_TEXT_CFGS = {
    "MobileCLIP-S0": dict(dim=512, layers=4, heads=8, variant="mct", causal=False),
    "MobileCLIP-S1": dict(dim=512, layers=12, heads=8, variant="base", causal=False),
    "MobileCLIP2-S0": dict(dim=512, layers=12, heads=8, variant="base", causal=False),
    "MobileCLIP2-S2": dict(dim=512, layers=12, heads=8, variant="base", causal=False),
    "MobileCLIP-B": dict(dim=512, layers=12, heads=8, variant="base", causal=True),
    "MobileCLIP2-S3": dict(dim=768, layers=12, heads=12, variant="base", causal=False),
    "MobileCLIP2-S4": dict(dim=768, layers=12, heads=12, variant="base", causal=False),
    "MobileCLIP2-L": dict(dim=768, layers=12, heads=12, variant="base", causal=False),
}


def ffn_dim(dim: int, mult: float = 4.0) -> int:
    return int(math.ceil(dim * mult / 16.0) * 16.0)


class LayerNormFP32(nn.Module):
    """LayerNorm computed in fp32, returned in the input dtype (eps 1e-5)."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = LayerNorm(dim, 1e-5)

    def forward(self, x):
        return self.ln(x.float()).to(x.dtype)


class PackedMHA(nn.Module):
    """MobileCLIP MultiHeadAttention: packed qkv projection. The tower
    attends over every token, padding included, as the JAX tower does."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.qkv_proj = Dense(embed_dim, 3 * embed_dim, dtype=dtype)
        self.out_proj = Dense(embed_dim, embed_dim, dtype=dtype)

    def forward(self, x, attn_bias=None):
        """attn_bias: an fp32 additive bias on the logits (the causal mask)."""
        q, k, v = self.qkv_proj(x).chunk(3, dim=-1)
        qh = split_heads(q, self.num_heads) * (self.embed_dim // self.num_heads) ** -0.5
        kh = split_heads(k, self.num_heads)
        vh = split_heads(v, self.num_heads)
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        if attn_bias is not None:
            logits = logits + attn_bias
        probs = torch.softmax(logits, dim=-1).to(vh.dtype)
        return self.out_proj(merge_heads(torch.matmul(probs, vh)))


class EncoderLayer(nn.Module):
    """Pre-norm MHA + FFN with fp32 LayerNorms."""

    def __init__(self, dim: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_mha = LayerNormFP32(dim)
        self.attn = PackedMHA(dim, heads, dtype=dtype)
        self.norm_ffn = LayerNormFP32(dim)
        self.fc1 = Dense(dim, ffn_dim(dim), dtype=dtype)
        self.fc2 = Dense(ffn_dim(dim), dim, dtype=dtype)

    def forward(self, x, attn_bias=None):
        x = x + self.attn(self.norm_mha(x), attn_bias)
        h = self.fc2(gelu_exact(self.fc1(self.norm_ffn(x))))
        return x + h


class MobileOneBlock1xK(nn.Module):
    """Train-form MobileOne block with a (1, k) depthwise kernel over
    (B, 1, L, D): identity BN plus optional conv+BN branches."""

    def __init__(self, d: int, k: int, num_conv_branches: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_conv_branches = num_conv_branches
        self.rbr_skip = BatchNorm(d, 1e-5, dtype=dtype)
        for i in range(num_conv_branches):
            setattr(self, f"rbr_conv_{i}_conv",
                    Conv(d, d, (1, k), padding=(0, k // 2), groups=d, bias=False, dtype=dtype))
            setattr(self, f"rbr_conv_{i}_bn", BatchNorm(d, 1e-5, dtype=dtype))

    def forward(self, x):
        out = self.rbr_skip(x)
        for i in range(self.num_conv_branches):
            y = getattr(self, f"rbr_conv_{i}_conv")(x)
            out = out + getattr(self, f"rbr_conv_{i}_bn")(y)
        return out


class RepMixerBlock(nn.Module):
    """Token mixing + ConvFFN over the sequence axis; (B, L, D) in and out."""

    def __init__(self, d: int, kernel_size: int = 11, ffn_kernel_size: int = 11,
                 mlp_ratio: float = 4.0, layer_scale_init: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.token_mixer_mixer = MobileOneBlock1xK(d, kernel_size, 1, dtype=dtype)
        self.token_mixer_norm = MobileOneBlock1xK(d, kernel_size, 0, dtype=dtype)
        self.token_mixer_layer_scale = nn.Parameter(torch.full((d,), layer_scale_init))
        self.convffn_conv = Conv(d, d, (1, ffn_kernel_size), padding=(0, ffn_kernel_size // 2),
                                 groups=d, bias=False, dtype=dtype)
        self.convffn_bn = BatchNorm(d, 1e-5, dtype=dtype)
        hidden = int(d * mlp_ratio)
        self.convffn_fc1 = Conv(d, hidden, 1, dtype=dtype)
        self.convffn_fc2 = Conv(hidden, d, 1, dtype=dtype)
        self.layer_scale = nn.Parameter(torch.full((d,), layer_scale_init))

    def forward(self, x):
        z = x[:, None]  # (B, 1, L, D) NHWC
        mixer = self.token_mixer_mixer(z)
        norm = self.token_mixer_norm(z)
        z = z + self.token_mixer_layer_scale * (mixer - norm)
        f = self.convffn_bn(self.convffn_conv(z))
        f = self.convffn_fc2(gelu_exact(self.convffn_fc1(f)))
        z = z + self.layer_scale * f
        return z[:, 0]


class MobileCLIPTextTransformer(nn.Module):
    """Tokens -> per-token features (the return-all-tokens path): 'base'
    (``layers`` transformer layers, ``transformer_0..``) or 'mct'
    (RepMixer, ``layers`` transformer layers, RepMixer)."""

    def __init__(self, dim: int = 512, layers: int = 12, heads: int = 8,
                 variant: str = "base", causal: bool = False, context_length: int = 77,
                 vocab_size: int = 49408, projection_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.causal = causal
        self.embedding_layer = Embed(vocab_size, dim)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, dim))
        blocks = [EncoderLayer(dim, heads, dtype=dtype) for _ in range(layers)]
        if variant == "mct":
            blocks = [RepMixerBlock(dim, dtype=dtype), *blocks, RepMixerBlock(dim, dtype=dtype)]
        self.transformer = nn.ModuleList(blocks)
        self.final_layer_norm = LayerNormFP32(dim)
        # present in checkpoints, unused on the SAM3 token path
        self.projection_layer = nn.Parameter(torch.empty(dim, projection_dim or dim))

    def forward(self, tokens):
        seq = tokens.shape[1]
        x = self.embedding_layer(tokens) + self.positional_embedding[:seq]
        bias = None
        if self.causal:
            neg = torch.finfo(torch.float32).min
            bias = torch.full((seq, seq), neg, dtype=torch.float32,
                              device=x.device).triu(1)[None, None]
        for blk in self.transformer:
            x = blk(x, bias) if isinstance(blk, EncoderLayer) else blk(x)
        return self.final_layer_norm(x)


class TextStudentEncoder(nn.Module):
    """LiteText student: MobileCLIP tower + linear projector to d_model.

    Returns (text_memory (B, L, d_model), pad_mask (B, L) True = pad).
    """

    def __init__(self, backbone_type: str = "MobileCLIP-S0", context_length: int = 77,
                 output_dim: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = MOBILECLIP_TEXT_CFGS[backbone_type]
        self.encoder = MobileCLIPTextTransformer(
            dim=cfg["dim"], layers=cfg["layers"], heads=cfg["heads"], variant=cfg["variant"],
            causal=cfg["causal"], context_length=context_length, projection_dim=cfg["dim"],
            dtype=dtype,
        )
        self.projector = Dense(cfg["dim"], output_dim, dtype=dtype)

    def forward(self, tokens):
        feats = self.encoder(tokens)
        return self.projector(feats), tokens == 0


def truncate_pos_embed(state: dict, new_length: int) -> dict:
    """A copy of a ``TextStudentEncoder`` state_dict whose positional table
    is cut to its first ``new_length`` rows: the reference's
    resize_pos_embed in its truncation case (ctx 77 -> 16/32)."""
    out = dict(state)
    out["encoder.positional_embedding"] = state["encoder.positional_embedding"][:new_length].clone()
    return out
