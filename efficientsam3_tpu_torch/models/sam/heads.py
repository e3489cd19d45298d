"""SAM prompt encoder, two-way transformer and mask decoder (NHWC).

Counterpart of efficientsam3_tpu/models/sam/heads.py. The mask decoder
defaults to the SAM2 configuration (the tracker's): the object-score
token, the high-res skip features and the dynamic multimask choice by
stability; ``sam1=True`` turns the three off together, as the SAM1
students' JAX decoder sets them. Prompts are fixed-width padded arrays
(label -1 pads), as in the JAX package.
``MaskDecoder`` in training mode (``.train()``, the JAX ``train=True``)
takes no dynamic multimask choice: a single-mask call returns mask 0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    MLP,
    Attention,
    Conv,
    ConvTranspose2x,
    Embed,
    LayerNorm,
    LayerNorm2d,
    MLPBlock,
    PositionEmbeddingRandom,
    gelu_exact,
)


class PromptEncoder(nn.Module):
    """Padded point/box prompts and optional mask prompts -> (sparse, dense).

    Point labels: -1 padding, 0 negative click, 1 positive click, 2 box
    top-left corner, 3 box bottom-right corner.
    """

    def __init__(self, embed_dim: int = 256, image_embedding_size=(72, 72),
                 input_image_size=(1008, 1008), mask_inputs: bool = True):
        """mask_inputs=False leaves out the mask downscaler (the SAM1
        students never take a mask prompt, and their JAX tree has none)."""
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(Embed(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = Embed(1, embed_dim)
        self.no_mask_embed = Embed(1, embed_dim)
        if mask_inputs:
            c = 16  # mask_in_chans
            self.mask_down = nn.ModuleList([
                Conv(1, c // 4, 2, stride=2), Conv(c // 4, c, 2, stride=2), Conv(c, embed_dim, 1),
            ])
            self.mask_down_ln0 = LayerNorm2d(c // 4)
            self.mask_down_ln1 = LayerNorm2d(c)

    def embed_points(self, points, labels):
        """points (B, P, 2) pixel xy; labels (B, P) int -> (B, P, C)."""
        size = torch.tensor([self.input_image_size[1], self.input_image_size[0]],
                            dtype=torch.float32, device=points.device)
        pe = self.pe_layer((points.float() + 0.5) / size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        for i in range(4):
            emb = torch.where(lab == i, pe + self.point_embeddings[i].weight[0], emb)
        return emb

    def embed_masks(self, masks):
        """masks (B, 4*Eh, 4*Ew, 1) -> (B, Eh, Ew, C)."""
        x = gelu_exact(self.mask_down_ln0(self.mask_down[0](masks)))
        x = gelu_exact(self.mask_down_ln1(self.mask_down[1](x)))
        return self.mask_down[2](x)

    def dense_pe(self):
        return self.pe_layer.grid(*self.image_embedding_size)

    def forward(self, points, labels, masks=None):
        sparse = self.embed_points(points, labels)
        if masks is not None:
            dense = self.embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight[0].expand(points.shape[0], h, w, self.embed_dim)
        return sparse, dense


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, skip_first_layer_pe: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = embedding_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(d, num_heads, dtype=dtype)
        self.norm1 = LayerNorm(d)
        self.cross_attn_token_to_image = Attention(d, num_heads, attention_downsample_rate,
                                                   dtype=dtype)
        self.norm2 = LayerNorm(d)
        self.mlp = MLPBlock(d, mlp_dim, F.relu)
        self.norm3 = LayerNorm(d)
        self.cross_attn_image_to_token = Attention(d, num_heads, attention_downsample_rate,
                                                   dtype=dtype)
        self.norm4 = LayerNorm(d)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0), dtype=dtype)
            for i in range(depth)
        )
        self.final_attn_token_to_image = Attention(embedding_dim, num_heads,
                                                   attention_downsample_rate, dtype=dtype)
        self.norm_final_attn = LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe (B, H, W, C); point_embedding (B, N, C)."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(image_pe.shape[0], h * w, c) if image_pe.ndim == 4 else image_pe
        key_pe = key_pe.expand(keys.shape)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    """Mask decoder, by default SAM2's: object-score token, high-res
    skips, dynamic multimask by stability; ``sam1=True`` leaves the three
    out (object score logits are then a constant 10). The JAX
    module's other defaults are fixed here (3 multimask outputs, a 3-layer
    256-wide IoU head with sigmoid, the multimask token for the object
    pointer, stability delta 0.05 and threshold 0.98, a 2-layer 8-head
    two-way transformer); no caller sets them."""

    num_mask_tokens = 4
    stability_delta = 0.05
    stability_thresh = 0.98

    def __init__(self, transformer_dim: int = 256, sam1: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = transformer_dim
        self.transformer_dim = d
        self.sam1 = sam1
        self.transformer = TwoWayTransformer(2, d, 8, 2048, dtype=dtype)
        self.iou_token = Embed(1, d)
        self.mask_tokens = Embed(self.num_mask_tokens, d)
        if not sam1:
            self.obj_score_token = Embed(1, d)
            self.pred_obj_score_head = MLP(d, d, 1, 3)
        self.output_upscaling = nn.ModuleList([ConvTranspose2x(d, d // 4),
                                               ConvTranspose2x(d // 4, d // 8)])
        self.output_upscaling_ln = LayerNorm2d(d // 4)
        if not sam1:
            self.conv_s0 = Conv(d, d // 8, 1)
            self.conv_s1 = Conv(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, 256, self.num_mask_tokens, 3, sigmoid_output=True)

    def high_res_convs(self, feat_s0, feat_s1):
        """Project the SAM2-neck levels for the skip connections (NHWC)."""
        return self.conv_s0(feat_s0), self.conv_s1(feat_s1)

    def predict_masks(self, image_embeddings, image_pe, sparse, dense, high_res_features=None):
        b = sparse.shape[0]
        d = self.transformer_dim
        toks = [self.iou_token.weight, self.mask_tokens.weight]
        s = 0
        if not self.sam1:
            toks, s = [self.obj_score_token.weight] + toks, 1
        output_tokens = torch.cat(toks, dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, d), sparse], dim=1)
        src = image_embeddings.expand(b, *image_embeddings.shape[1:]) + dense
        if image_pe.ndim == 3:
            image_pe = image_pe[None]
        hs, src_out = self.transformer(src, image_pe.expand(src.shape), tokens)
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1:s + 1 + self.num_mask_tokens]

        h, w = src.shape[1:3]
        src_img = src_out.reshape(b, h, w, d)
        up0, up1 = self.output_upscaling
        if not self.sam1 and high_res_features is not None:
            feat_s0, feat_s1 = high_res_features
            up = gelu_exact(self.output_upscaling_ln(up0(src_img) + feat_s1))
            up = gelu_exact(up1(up) + feat_s0)
        else:
            up = gelu_exact(self.output_upscaling_ln(up0(src_img)))
            up = gelu_exact(up1(up))
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i])
                                for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("btc,bhwc->bthw", hyper_in.float(), up.float()).to(up.dtype)
        iou_pred = self.iou_prediction_head(iou_token_out)
        if not self.sam1:
            object_score_logits = self.pred_obj_score_head(hs[:, 0])
        else:
            object_score_logits = torch.full((b, 1), 10.0, dtype=iou_pred.dtype,
                                             device=iou_pred.device)
        return masks, iou_pred, mask_tokens_out, object_score_logits

    def _stability_scores(self, mask_logits):
        flat = mask_logits.flatten(-2)
        area_i = (flat > self.stability_delta).sum(-1).float()
        area_u = (flat > -self.stability_delta).sum(-1).float()
        return torch.where(area_u > 0, area_i / area_u.clamp_min(1.0), 1.0)

    def _dynamic_multimask(self, all_masks, all_ious):
        multi, multi_iou = all_masks[:, 1:], all_ious[:, 1:]
        best = multi_iou.argmax(-1)
        idx = torch.arange(multi.shape[0], device=multi.device)
        best_mask = multi[idx, best][:, None]
        best_iou = multi_iou[idx, best][:, None]
        single_mask, single_iou = all_masks[:, 0:1], all_ious[:, 0:1]
        stable = self._stability_scores(single_mask) >= self.stability_thresh
        return (torch.where(stable[..., None, None], single_mask, best_mask),
                torch.where(stable, single_iou, best_iou))

    def forward(self, image_embeddings, image_pe, sparse, dense, multimask_output: bool,
                high_res_features=None):
        """-> (masks, ious, sam output tokens, object score logits). Without
        multimask output: the dynamic choice by stability in eval mode (when
        the decoder takes it), else mask 0."""
        masks, iou_pred, mask_tokens_out, object_score_logits = self.predict_masks(
            image_embeddings, image_pe, sparse, dense, high_res_features)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:], mask_tokens_out[:, 1:], object_score_logits
        if not (self.sam1 or self.training):
            out_masks, out_ious = self._dynamic_multimask(masks, iou_pred)
        else:
            out_masks, out_ious = masks[:, 0:1], iou_pred[:, 0:1]
        return out_masks, out_ious, mask_tokens_out[:, 0:1], object_score_logits
