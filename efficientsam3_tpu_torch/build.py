"""Model builders: the public construction API of the port.

Counterpart of efficientsam3_tpu/build.py for the image model with a
student trunk (EfficientViT b0/b1/b2, RepViT m0.9/m1.1/m2.3 or TinyViT
5m/11m/21m; S/M/L by the model zoo's aliases) and a MobileCLIP text tower
(any ``models.mobile_clip.MOBILECLIP_TEXT_CFGS`` entry, MobileCLIP-S0 by
default), for the SAM3 teacher (ViTDet ViT-H trunk and the CLIP text tower), and for
the video models: each image model with the SAM2 neck, plus the tracker
core.
Parameters are drawn from a seeded ``torch.Generator`` (no released
weights are in the repository); ``utils/convert.py`` carries weights over
from the JAX package's variables instead.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Union

import torch

from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.models.efficientvit import EFFICIENTVIT_VARIANTS
from efficientsam3_tpu_torch.models.repvit import REPVIT_VARIANTS
from efficientsam3_tpu_torch.models.sam3_image import Sam3ImageModel
from efficientsam3_tpu_torch.models.student_encoder import ImageStudentEncoder
from efficientsam3_tpu_torch.models.tiny_vit import TINYVIT_VARIANTS
from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
from efficientsam3_tpu_torch.video.tracker import TrackerCore, init_tracker_parameters

BACKBONE_REGISTRY = {
    "efficientvit": EFFICIENTVIT_VARIANTS,
    "repvit": REPVIT_VARIANTS,
    "tinyvit": TINYVIT_VARIANTS,
}

# model-zoo shorthand
SIZE_ALIASES = {
    ("efficientvit", "s"): "b0", ("efficientvit", "m"): "b1", ("efficientvit", "l"): "b2",
    ("repvit", "s"): "m0.9", ("repvit", "m"): "m1.1", ("repvit", "l"): "m2.3",
    ("tinyvit", "s"): "5m", ("tinyvit", "m"): "11m", ("tinyvit", "l"): "21m",
}


def make_trunk(backbone_type: str, model_name: str, dtype: Optional[torch.dtype] = None):
    """The student trunk ``BACKBONE_REGISTRY[backbone_type][model_name]``
    (model-zoo aliases resolved); its ``out_channels`` is the width of the
    map it returns."""
    model_name = SIZE_ALIASES.get((backbone_type, model_name.lower()), model_name)
    return BACKBONE_REGISTRY[backbone_type][model_name](dtype=dtype)


def make_student_trunk(backbone_type: str = "efficientvit", model_name: str = "b1",
                       embed_dim: int = 1024, embed_size: int = 72,
                       dtype: Optional[torch.dtype] = None) -> ImageStudentEncoder:
    """Student trunk + projection head -> (B, embed_size, embed_size, embed_dim)."""
    trunk = make_trunk(backbone_type, model_name, dtype)
    return ImageStudentEncoder(trunk, trunk.out_channels, embed_dim, embed_size, dtype=dtype)


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
    dropout: float = 0.1,
) -> Sam3ImageModel:
    """EfficientSAM3 image model with a student trunk and the LiteText
    tower, seeded random weights, in eval mode with gradients off on
    ``device`` (default cuda); ``train/stage3.prepare_for_training`` turns
    both on for training.

    ``fusion_layers`` / ``decoder_layers`` cut depth for small test configs;
    ``dropout`` is the training dropout rate of the JAX layers (0.1; the
    parity tests set 0, since the two frameworks draw different bits).
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
        dropout=dropout,
        dtype=dtype,
    )
    init_parameters(model, seed)
    return model.requires_grad_(False).eval().to(device)


def build_efficientsam3_video_model(
    backbone_type: str = "efficientvit",
    model_name: str = "b1",
    text_encoder_type: Optional[str] = "MobileCLIP-S0",
    text_encoder_context_length: int = 77,
    embed_size: int = 72,
    dtype: Optional[torch.dtype] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> tuple[Sam3ImageModel, TrackerCore]:
    """(image_model, tracker_core) for video: the image model with the SAM2
    neck (``enable_inst_interactivity``) and a TrackerCore at image size
    embed_size * 14 (72x72 tokens at 1008), both with seeded random weights
    from ``seed``, in eval mode on ``device`` (default cuda).

    The text tower defaults to MobileCLIP-S0 (the JAX package's function
    defaults to the teacher's CLIP tower, ``text_encoder_type=None``
    here too). Wire them with ``video.predictor.TrackerPredictor(
    tracker_core, image_model.encode_image)``.
    """
    device = resolve_device(device)
    image_model = build_efficientsam3_image_model(
        backbone_type=backbone_type, model_name=model_name,
        text_encoder_type=text_encoder_type,
        text_encoder_context_length=text_encoder_context_length,
        enable_inst_interactivity=True, embed_size=embed_size, dtype=dtype, device=device,
        seed=seed)
    core = init_tracker_parameters(
        TrackerCore(image_size=embed_size * 14, backbone_stride=14, dtype=dtype), seed)
    return image_model, core.requires_grad_(False).eval().to(device)


def build_sam3_image_model(
    text_encoder_context_length: int = 77,
    enable_inst_interactivity: bool = False,
    dtype: Optional[torch.dtype] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> Sam3ImageModel:
    """The SAM3 teacher: ViTDet ViT-H trunk (1008^2 -> 72x72x1024) and the
    24-layer CLIP text tower, seeded random weights, in eval mode with
    gradients off on ``device`` (default cuda); its trunk trains through
    ``train/stage1.py`` (drop path 0 there, as in JAX). On the ``meta``
    device the module is built without storage or initialisation (its key
    map and shapes only)."""
    device = resolve_device(device)
    meta = device.type == "meta"
    with torch.device("meta") if meta else contextlib.nullcontext():
        model = Sam3ImageModel(
            trunk=ViTTrunk(dtype=dtype), text_encoder_type=None,
            text_context_length=text_encoder_context_length,
            add_sam2_neck=enable_inst_interactivity, dtype=dtype)
    if not meta:
        init_parameters(model, seed)
    return model.requires_grad_(False).eval().to(device)


def build_sam3_video_model(
    text_encoder_context_length: int = 77,
    dtype: Optional[torch.dtype] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> tuple[Sam3ImageModel, TrackerCore]:
    """(image_model, tracker_core) of the SAM3 teacher for video: the
    teacher image model with the SAM2 neck and a TrackerCore at 1008^2
    (72x72 tokens at stride 14), seeded random weights from ``seed``, in
    eval mode on ``device`` (default cuda). Wire them with
    ``video.predictor.TrackerPredictor(tracker_core, image_model.encode_image)``.
    """
    device = resolve_device(device)
    image_model = build_sam3_image_model(
        text_encoder_context_length, enable_inst_interactivity=True, dtype=dtype,
        device=device, seed=seed)
    core = init_tracker_parameters(
        TrackerCore(image_size=1008, backbone_stride=14, dtype=dtype), seed)
    return image_model, core.requires_grad_(False).eval().to(device)
