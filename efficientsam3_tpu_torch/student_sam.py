"""Standalone SAM1-style student models (the EdgeSAM lineage).

Counterpart of efficientsam3_tpu/student_sam.py: SAM1 models whose image
encoder is a distilled student trunk (RepViT / TinyViT / EfficientViT) or
a ViT, under the original SAM prompt encoder and mask decoder (no
object-score head, no high-res skip features, no dynamic multimask: the
SAM1 configuration), at image_size 1024 / 64x64 embeddings. NHWC
throughout, ``encode_image`` and ``predict_masks`` as in JAX, and the
predictor facade ``SamStudentPredictor`` (``set_image``, ``predict``).

The builders draw seeded parameters (``build.init_parameters``) and return
the model in eval mode with gradients off on ``device`` (default cuda;
``meta`` builds the module without storage). The ViT students' 64x64 token
grid at 1024^2 does not split into their 14-token windows, so their
windowed blocks raise there, as the JAX blocks assert. Their trunk runs
under heads for 1120^2 (70x70 tokens, 5x5 windows), the JAX
``SamStudentModel(trunk=..., image_size=1120)``:
``SamStudentModel(trunk=m.trunk, image_size=1120, dtype=...)`` loaded with
``m.state_dict()`` (the prompt encoder's tables do not depend on the input
size); ``encode_image`` resizes its 70x70 map to 64x64.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from efficientsam3_tpu_torch.build import init_parameters, make_trunk
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.models.common import Conv, LayerNorm
from efficientsam3_tpu_torch.models.sam import MaskDecoder, PromptEncoder
from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
from efficientsam3_tpu_torch.ops.interpolate import resize_antialiased, resize_bilinear


class SamStudentModel(nn.Module):
    """SAM1 student: trunk -> 256-channel 64x64 embeddings -> SAM heads.

    ``trunk`` returns an NHWC map of ``trunk.out_channels`` channels."""

    def __init__(self, trunk: nn.Module, image_size: int = 1024, embed_size: int = 64,
                 d_model: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.trunk = trunk
        self.image_size = image_size
        self.embed_size = embed_size
        # the neck takes no dtype in JAX: it computes in promote(x, fp32)
        self.neck_conv1 = Conv(trunk.out_channels, d_model, 1, bias=False)
        self.neck_ln1 = LayerNorm(d_model, 1e-6)
        self.neck_conv2 = Conv(d_model, d_model, 3, padding=1, bias=False)
        self.neck_ln2 = LayerNorm(d_model, 1e-6)
        self.sam_prompt_encoder = PromptEncoder(d_model, (embed_size, embed_size),
                                                (image_size, image_size), mask_inputs=False)
        self.sam_mask_decoder = MaskDecoder(d_model, sam1=True, dtype=dtype)

    def encode_image(self, images):
        """(B, H, W, 3) normalized -> (B, 64, 64, 256) fp32."""
        feats = self.trunk(images)
        feats = self.neck_ln2(self.neck_conv2(self.neck_ln1(self.neck_conv1(feats))))
        if feats.shape[1:3] != (self.embed_size, self.embed_size):
            feats = resize_antialiased(feats, (self.embed_size, self.embed_size))
        return feats

    def predict_masks(self, embeddings, point_coords, point_labels, multimask_output: bool):
        """embeddings (B, 64, 64, 256); coords (B, P, 2) in input pixels,
        labels (B, P) (-1 pads, 2 / 3 box corners) -> (low-res mask logits
        (B, M, 256, 256), predicted IoUs (B, M)), M = 3 or 1."""
        sparse, dense = self.sam_prompt_encoder(point_coords, point_labels, None)
        low_res, ious, _, _ = self.sam_mask_decoder(
            embeddings, self.sam_prompt_encoder.dense_pe(), sparse, dense, multimask_output)
        return low_res, ious

    def forward(self, images, point_coords, point_labels, multimask_output: bool = True):
        return self.predict_masks(self.encode_image(images), point_coords, point_labels,
                                  multimask_output)


def _finish(make, device, seed):
    """Build ``make()`` (on ``meta`` without storage), draw its seeded
    parameters, and return it in eval mode with gradients off on device."""
    device = resolve_device(device)
    meta = device.type == "meta"
    with torch.device("meta") if meta else contextlib.nullcontext():
        model = make()
    if not meta:
        init_parameters(model, seed)
    return model.requires_grad_(False).eval().to(device)


Device = Optional[Union[str, torch.device]]


def build_sam_student(backbone_type: str = "repvit", model_name: str = "m1.1",
                      dtype: Optional[torch.dtype] = None, device: Device = None,
                      seed: int = 0) -> SamStudentModel:
    """A SAM1 student over a student trunk of ``build.BACKBONE_REGISTRY``."""
    return _finish(lambda: SamStudentModel(make_trunk(backbone_type, model_name, dtype),
                                           dtype=dtype), device, seed)


def build_edge_sam(dtype: Optional[torch.dtype] = None, device: Device = None,
                   seed: int = 0) -> SamStudentModel:
    """EdgeSAM: the RepViT-M1.1 encoder."""
    return build_sam_student("repvit", "m1.1", dtype, device, seed)


VIT_STUDENTS = {
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, global_att_blocks=(2, 5, 8, 11)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, global_att_blocks=(5, 11, 17, 23)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, global_att_blocks=(7, 15, 23, 31)),
}


def build_sam_vit_student(variant: str = "vit_b", dtype: Optional[torch.dtype] = None,
                          device: Device = None, seed: int = 0) -> SamStudentModel:
    """A ViT-encoder SAM1 student: the ViTDet trunk at the SAM1 widths and
    depths (patch 16, window 14, pretraining grid 64, MLP 4.0). At its
    image_size 1024 the windowed blocks raise (the JAX trunk asserts there
    too); see the module's note for 1120."""

    def make():
        trunk = ViTTrunk(patch_size=16, window_size=14, pretrain_grid=64, mlp_ratio=4.0,
                         dtype=dtype, **VIT_STUDENTS[variant])
        return SamStudentModel(trunk, dtype=dtype)

    return _finish(make, device, seed)


sam_model_registry = {
    "default": build_edge_sam,
    "edge_sam": build_edge_sam,
    "vit_b": lambda dtype=None, **kw: build_sam_vit_student("vit_b", dtype, **kw),
    "vit_l": lambda dtype=None, **kw: build_sam_vit_student("vit_l", dtype, **kw),
    "vit_h": lambda dtype=None, **kw: build_sam_vit_student("vit_h", dtype, **kw),
    "repvit": lambda dtype=None, **kw: build_sam_student("repvit", "m1.1", dtype, **kw),
    "tinyvit": lambda dtype=None, **kw: build_sam_student("tinyvit", "5m", dtype, **kw),
    "efficientvit": lambda dtype=None, **kw: build_sam_student("efficientvit", "b1", dtype,
                                                                **kw),
}


class SamStudentPredictor:
    """SAM1 predictor facade over a ``SamStudentModel``: one image
    embedding cached by ``set_image``, prompts in original pixels."""

    def __init__(self, model: SamStudentModel):
        self.model = model
        self.device = next(model.parameters()).device
        self._emb = None
        self._orig_hw = None

    @torch.inference_mode()
    def set_image(self, image: np.ndarray):
        """image (H, W, 3) uint8 or float: resized to the model's square
        input (antialiased linear), normalised with mean = std = 0.5."""
        h, w = image.shape[:2]
        x = torch.as_tensor(np.asarray(image), device=self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        r = self.model.image_size
        x = ((resize_antialiased(x, (r, r)) - 0.5) / 0.5)[None]
        self._emb = self.model.encode_image(x)
        self._orig_hw = (h, w)

    @torch.inference_mode()
    def predict(self, point_coords=None, point_labels=None, box=None,
                multimask_output: bool = True):
        """point_coords (P, 2) and box (4,) xyxy in original pixels ->
        (masks (M, H, W) bool, iou_predictions (M,), low_res (M, 256, 256))."""
        if self._emb is None:
            raise ValueError("call set_image first")
        h, w = self._orig_hw
        r = self.model.image_size
        sx, sy = r / w, r / h
        n = (2 if box is not None else 0) + (len(point_coords) if point_coords is not None
                                             else 0)
        pts = np.zeros((1, n + 1, 2), np.float32)  # one pad point, as the JAX predictor
        labs = -np.ones((1, n + 1), np.int64)
        k = 0
        if box is not None:
            b = np.asarray(box, np.float32)
            pts[0, 0] = [b[0] * sx, b[1] * sy]
            pts[0, 1] = [b[2] * sx, b[3] * sy]
            labs[0, 0], labs[0, 1] = 2, 3
            k = 2
        if point_coords is not None:
            p = np.asarray(point_coords, np.float32) * [sx, sy]  # float64, as JAX's
            pts[0, k:k + len(p)] = p
            labs[0, k:k + len(p)] = np.asarray(point_labels, np.int64)
        low, ious = self.model.predict_masks(
            self._emb, torch.as_tensor(pts, device=self.device),
            torch.as_tensor(labs, device=self.device), multimask_output)
        masks = resize_bilinear(low.float(), (h, w))[0].cpu().numpy() > 0
        return masks, ious[0].float().cpu().numpy(), low[0].float().cpu().numpy()
