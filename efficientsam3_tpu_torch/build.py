"""Model builders: the public construction API of the port.

Counterpart of efficientsam3_tpu/build.py for the image model with an
EfficientViT student trunk (S/M = b0/b1) and the MobileCLIP-S0 text tower.
Parameters are drawn from a seeded ``torch.Generator`` (no released
weights are in the repository); ``utils/convert.py`` carries weights over
from the JAX package's variables instead.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.models.efficientvit import (
    EFFICIENTVIT_OUT_CHANNELS,
    EFFICIENTVIT_VARIANTS,
)
from efficientsam3_tpu_torch.models.sam3_image import Sam3ImageModel
from efficientsam3_tpu_torch.models.student_encoder import ImageStudentEncoder

SIZE_ALIASES = {("efficientvit", "s"): "b0", ("efficientvit", "m"): "b1"}


def make_student_trunk(backbone_type: str = "efficientvit", model_name: str = "b1",
                       embed_dim: int = 1024, embed_size: int = 72,
                       dtype: Optional[torch.dtype] = None) -> ImageStudentEncoder:
    """Student trunk + projection head -> (B, embed_size, embed_size, embed_dim)."""
    if backbone_type != "efficientvit":
        raise NotImplementedError(
            f"backbone {backbone_type!r} is not ported yet: RepViT and TinyViT trunks are "
            "ROADMAP Queue 1 item 16 (other trunks and towers)"
        )
    model_name = SIZE_ALIASES.get((backbone_type, model_name.lower()), model_name)
    if model_name not in EFFICIENTVIT_VARIANTS:
        raise NotImplementedError(
            f"EfficientViT {model_name!r} is not ported yet (ROADMAP Queue 1 item 16)"
        )
    trunk = EFFICIENTVIT_VARIANTS[model_name](dtype=dtype)
    return ImageStudentEncoder(trunk, EFFICIENTVIT_OUT_CHANNELS[model_name], embed_dim,
                               embed_size, dtype=dtype)


@torch.no_grad()
def init_parameters(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded random parameters: fan-in scaled normals for matrices and
    kernels, ones for norm scales, zeros for biases, 1e-5 layer scales."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            val = torch.zeros(p.shape)
        elif leaf in ("token_mixer_layer_scale", "layer_scale"):
            val = torch.full(p.shape, 1e-5)
        elif p.ndim == 1:
            val = torch.ones(p.shape)
        else:
            fan_in = math.prod(p.shape[1:])
            val = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
        p.copy_(val)
    return model


def build_efficientsam3_image_model(
    backbone_type: str = "efficientvit",
    model_name: str = "b1",
    text_encoder_type: Optional[str] = "MobileCLIP-S0",
    text_encoder_context_length: int = 77,
    enable_inst_interactivity: bool = False,
    embed_size: int = 72,
    dtype: Optional[torch.dtype] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    fusion_layers: int = 6,
    decoder_layers: int = 6,
) -> Sam3ImageModel:
    """EfficientSAM3 image model with a student trunk and the LiteText
    tower, seeded random weights, in eval mode on ``device`` (default cuda).

    ``fusion_layers`` / ``decoder_layers`` cut depth for small test configs.
    """
    device = resolve_device(device)
    trunk = make_student_trunk(backbone_type, model_name, embed_size=embed_size, dtype=dtype)
    model = Sam3ImageModel(
        trunk=trunk,
        text_encoder_type=text_encoder_type,
        text_context_length=text_encoder_context_length,
        add_sam2_neck=enable_inst_interactivity,
        fusion_layers=fusion_layers,
        decoder_layers=decoder_layers,
        dtype=dtype,
    )
    init_parameters(model, seed)
    return model.requires_grad_(False).eval().to(device)
