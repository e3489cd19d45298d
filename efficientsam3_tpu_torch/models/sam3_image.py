"""EfficientSAM3 image PCS model: trunk -> neck -> fusion -> decoder -> heads.

Counterpart of efficientsam3_tpu/models/sam3_image.py with the same three
entry methods and outputs, over a student trunk with a MobileCLIP tower
(EfficientSAM3) or the ViTDet trunk with the CLIP tower
(``text_encoder_type=None``: the SAM3 teacher): ``encode_image`` (FPN
levels after scalp=1, NHWC, and their sine position embeddings),
``encode_text`` (text memory and pad mask) and ``ground`` (geometry
encoder, fusion encoder, decoder, scoring, boxes and masks).

Training is the module's training mode (``model.train()``), the JAX
``train=True``: BatchNorm takes batch statistics, dropout is on, the
decoder runs DAC (o2o + o2m queries), the boxRPB attention takes its
differentiable matmul path, and ``ground`` adds the training outputs
(``aux`` per-layer logits, boxes and presence logits, the ``*_o2m``
outputs and ``all_presence_logits``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientsam3_tpu_torch.models.decoder import (
    DotProductScoring,
    TransformerDecoder,
    box_cxcywh_to_xyxy,
    inverse_sigmoid,
)
from efficientsam3_tpu_torch.models.fusion_encoder import FusionEncoder
from efficientsam3_tpu_torch.models.geometry import Prompt, SequenceGeometryEncoder
from efficientsam3_tpu_torch.models.mobile_clip import TextStudentEncoder
from efficientsam3_tpu_torch.models.necks import DualFPNNeck
from efficientsam3_tpu_torch.models.seg_head import UniversalSegmentationHead
from efficientsam3_tpu_torch.models.text_encoder import VETextEncoder


class Sam3ImageModel(nn.Module):
    """Full PCS detector. Construct via efficientsam3_tpu_torch.build."""

    def __init__(self, trunk: nn.Module, text_encoder_type: str = "MobileCLIP-S0",
                 text_context_length: int = 77, d_model: int = 256, num_queries: int = 200,
                 add_sam2_neck: bool = False, fusion_layers: int = 6, decoder_layers: int = 6,
                 trunk_dim: int = 1024, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, text_tower: Optional[dict] = None):
        """text_encoder_type None builds the teacher's ``VETextEncoder``;
        ``text_tower`` overrides its width, heads and layers (small test
        configs)."""
        super().__init__()
        self.d_model = d_model
        self.num_queries = num_queries
        self.text_context_length = text_context_length
        self.trunk = trunk
        self.neck = DualFPNNeck(trunk_dim, d_model, add_sam2_neck=add_sam2_neck, dtype=dtype)
        if text_encoder_type is None:
            self.text_encoder = VETextEncoder(d_model, text_context_length, dtype=dtype,
                                              **(text_tower or {}))
        else:
            self.text_encoder = TextStudentEncoder(text_encoder_type, text_context_length,
                                                   d_model, dtype=dtype)
        self.geometry_encoder = SequenceGeometryEncoder(d_model=d_model, dropout=dropout,
                                                        dtype=dtype)
        self.fusion_encoder = FusionEncoder(fusion_layers, d_model, dropout=dropout, dtype=dtype)
        self.decoder = TransformerDecoder(decoder_layers, num_queries, d_model, dropout=dropout,
                                          dtype=dtype)
        self.seg_head = UniversalSegmentationHead(d_model, dtype=dtype)
        self.scoring = DotProductScoring(d_model, dropout=dropout, dtype=dtype)

    def encode_image(self, images):
        """images (B, H, W, 3) normalized -> {"fpn": [4x, 2x, 1x] NHWC levels,
        "pos": their (H, W, C) sine embeddings}."""
        embed = self.trunk(images)
        sam3_feats, sam3_pos, sam2_feats, sam2_pos = self.neck(embed)
        out = {"fpn": sam3_feats[:-1], "pos": sam3_pos[:-1]}
        if sam2_feats is not None:
            out["sam2_fpn"] = sam2_feats
            out["sam2_pos"] = sam2_pos
        return out

    def encode_text(self, tokens):
        """tokens (B, L) int -> (text_memory (B, L, C), pad_mask (B, L))."""
        return self.text_encoder(tokens)

    def ground(self, fpn, pos, text_memory, text_mask, prompt: Prompt):
        """Text + geometry grounding -> detection outputs (fixed shapes)."""
        b = fpn[-1].shape[0]
        h, w = fpn[-1].shape[1:3]
        img_tokens = fpn[-1].reshape(b, h * w, self.d_model)
        img_pos = pos[-1].reshape(h * w, self.d_model)

        geo_tokens, geo_mask = self.geometry_encoder(prompt, img_tokens, (h, w), img_pos)
        full_prompt = torch.cat([text_memory, geo_tokens], dim=1)  # promotes, as in JAX
        full_mask = torch.cat([text_mask, geo_mask], dim=1)

        memory = self.fusion_encoder(img_tokens, img_pos, full_prompt, full_mask)
        dec = self.decoder(memory, (h, w), memory_pos=img_pos[None].expand(memory.shape),
                           memory_text=full_prompt, text_key_padding_mask=full_mask,
                           apply_dac=self.training)
        hs = dec["hs"]
        logits = self.scoring(hs, full_prompt, full_mask)
        boxes = torch.sigmoid(self.decoder.bbox_embed(hs) + inverse_sigmoid(dec["references"]))
        seg = self.seg_head(fpn, hs[-1], memory, full_prompt, full_mask)
        nq = self.num_queries
        out = {
            "pred_logits": logits[-1][:, :nq],
            "pred_boxes": boxes[-1][:, :nq],
            "pred_boxes_xyxy": box_cxcywh_to_xyxy(boxes[-1][:, :nq]),
            "pred_masks": seg["pred_masks"][:, :nq],
            "semantic_seg": seg["semantic_seg"],
            "presence_logit_dec": dec["presence_logits"][-1],
            "queries": hs[-1][:, :nq],
            "encoder_hidden_states": memory,
        }
        if self.training:
            out["aux"] = {
                "pred_logits": logits[:-1],
                "pred_boxes": boxes[:-1],
                "presence_logits": dec["presence_logits"][:-1],
            }
            out["pred_logits_o2m"] = logits[-1][:, nq:]
            out["pred_boxes_o2m"] = boxes[-1][:, nq:]
            out["pred_masks_o2m"] = seg["pred_masks"][:, nq:]
            out["all_presence_logits"] = dec["presence_logits"]
        return out

    def forward(self, images, tokens, prompt: Prompt):
        img = self.encode_image(images)
        text_memory, text_mask = self.encode_text(tokens)
        return self.ground(img["fpn"], img["pos"], text_memory, text_mask, prompt)
