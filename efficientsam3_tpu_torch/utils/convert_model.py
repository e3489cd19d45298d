"""torch -> flax converters for the SAM3 detector stack + full-model compose.

The port's copy of efficientsam3_tpu/utils/convert_model.py (numpy only);
``convert_image_model`` reads the port's RepViT and MobileCLIP tables.

Covers every non-backbone subtree of the reference checkpoint
(facebook/sam3 `sam3.pt` / EfficientSAM3 `.pt` key space):
  backbone.language_backbone.*   -> text_encoder (teacher CLIP or MobileCLIP)
  backbone.vision_backbone.*     -> trunk + neck (see convert_backbones)
  geometry_encoder.*             -> geometry encoder
  transformer.encoder.*          -> fusion encoder
  transformer.decoder.*          -> DETR decoder
  segmentation_head.*            -> seg head
  dot_prod_scoring.*             -> scoring
  inst_interactive_predictor.model.* (remapped from tracker.*) -> TrackerCore

Each converter returns (params, batch_stats) numpy trees keyed by my flax
module names.
"""

from __future__ import annotations

from efficientsam3_tpu_torch.utils import convert_backbones as cb
from efficientsam3_tpu_torch.utils.torch_convert import (
    _np,
    batch_norm,
    conv,
    conv_transpose,
    convert_mask_decoder,
    convert_prompt_encoder,
    embed,
    layer_norm,
    layer_norm_2d,
    linear,
    mha,
    mlp,
    sam_attention,
)


# ---------------------------------------------------------------------------
# Text towers
# ---------------------------------------------------------------------------


def convert_ve_text_encoder(sd, p, layers=24):
    """reference text_encoder_ve.py VETextEncoder -> models/text_encoder.py."""
    enc = {
        "token_embedding": embed(sd, f"{p}.encoder.token_embedding"),
        "positional_embedding": _np(sd[f"{p}.encoder.positional_embedding"]),
        "ln_final": layer_norm(sd, f"{p}.encoder.ln_final"),
        "text_projection": _np(sd[f"{p}.encoder.text_projection"]),
    }
    for i in range(layers):
        rp = f"{p}.encoder.transformer.resblocks.{i}"
        enc[f"resblocks_{i}"] = {
            "ln_1": layer_norm(sd, f"{rp}.ln_1"),
            "attn": mha(sd, f"{rp}.attn"),
            "ln_2": layer_norm(sd, f"{rp}.ln_2"),
            "c_fc": linear(sd, f"{rp}.mlp.c_fc"),
            "c_proj": linear(sd, f"{rp}.mlp.c_proj"),
        }
    return {"encoder": enc, "resizer": linear(sd, f"{p}.resizer")}, {}


def _mobileone_1xk(sd, p, num_conv_branches=1):
    params, stats = {}, {}
    bnp, bns = batch_norm(sd, f"{p}.rbr_skip")
    params["rbr_skip"] = bnp
    stats["rbr_skip"] = bns
    for i in range(num_conv_branches):
        params[f"rbr_conv_{i}_conv"] = conv(sd, f"{p}.rbr_conv.{i}.conv")
        bnp, bns = batch_norm(sd, f"{p}.rbr_conv.{i}.bn")
        params[f"rbr_conv_{i}_bn"] = bnp
        stats[f"rbr_conv_{i}_bn"] = bns
    return params, stats


def _repmixer_block(sd, p):
    params, stats = {}, {}
    mp, ms = _mobileone_1xk(sd, f"{p}.token_mixer.mixer", 1)
    params["token_mixer_mixer"] = mp
    stats["token_mixer_mixer"] = ms
    np_, ns = _mobileone_1xk(sd, f"{p}.token_mixer.norm", 0)
    params["token_mixer_norm"] = np_
    stats["token_mixer_norm"] = ns
    params["token_mixer_layer_scale"] = _np(sd[f"{p}.token_mixer.layer_scale"]).reshape(-1)
    params["convffn_conv"] = conv(sd, f"{p}.convffn.conv.conv")
    bnp, bns = batch_norm(sd, f"{p}.convffn.conv.bn")
    params["convffn_bn"] = bnp
    stats["convffn_bn"] = bns
    params["convffn_fc1"] = conv(sd, f"{p}.convffn.fc1")
    params["convffn_fc2"] = conv(sd, f"{p}.convffn.fc2")
    params["layer_scale"] = _np(sd[f"{p}.layer_scale"]).reshape(-1)
    return params, stats


def _mc_encoder_layer(sd, p):
    return {
        "norm_mha": {"ln": layer_norm(sd, f"{p}.pre_norm_mha.0")},
        "attn": {
            "qkv_proj": linear(sd, f"{p}.pre_norm_mha.1.qkv_proj"),
            "out_proj": linear(sd, f"{p}.pre_norm_mha.1.out_proj"),
        },
        "norm_ffn": {"ln": layer_norm(sd, f"{p}.pre_norm_ffn.0")},
        "fc1": linear(sd, f"{p}.pre_norm_ffn.1"),
        "fc2": linear(sd, f"{p}.pre_norm_ffn.4"),
    }


def convert_mobileclip_text(sd, p, layers, variant="base"):
    """reference mobile_clip.py MobileCLIPTextTransformer (inside
    TextStudentEncoder) -> models/mobile_clip.py."""
    params, stats = {}, {}
    enc_p, enc_s = {}, {}
    enc_p["embedding_layer"] = embed(sd, f"{p}.encoder.embedding_layer")
    enc_p["positional_embedding"] = _np(
        sd[f"{p}.encoder.positional_embedding.pos_embed.pos_embed"]
    ).reshape(-1, _np(sd[f"{p}.encoder.positional_embedding.pos_embed.pos_embed"]).shape[-1])
    blocks = []
    if variant == "mct":
        blocks.append(("repmixer", 0))
        for i in range(layers):
            blocks.append(("enc", 1 + i))
        blocks.append(("repmixer", 1 + layers))
    else:
        for i in range(layers):
            blocks.append(("enc", i))
    for kind, idx in blocks:
        tp = f"{p}.encoder.transformer.{idx}"
        if kind == "repmixer":
            bp, bs = _repmixer_block(sd, tp)
            enc_p[f"transformer_{idx}"] = bp
            enc_s[f"transformer_{idx}"] = bs
        else:
            enc_p[f"transformer_{idx}"] = _mc_encoder_layer(sd, tp)
    enc_p["final_layer_norm"] = {"ln": layer_norm(sd, f"{p}.encoder.final_layer_norm")}
    enc_p["projection_layer"] = _np(sd[f"{p}.encoder.projection_layer"])
    params["encoder"] = enc_p
    if enc_s:
        stats["encoder"] = enc_s
    params["projector"] = linear(sd, f"{p}.projector")
    return params, stats


def convert_vitdet(sd, p, depth=32):
    """reference model/vitdet.py ViT trunk -> models/vitdet.ViTTrunk."""
    params = {
        "patch_embed": conv(sd, f"{p}.patch_embed.proj"),
        "pos_embed": _np(sd[f"{p}.pos_embed"])[0],
        "ln_pre": layer_norm(sd, f"{p}.ln_pre"),
    }
    for i in range(depth):
        bp = f"{p}.blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": layer_norm(sd, f"{bp}.norm1"),
            "attn": {
                "qkv": linear(sd, f"{bp}.attn.qkv"),
                "proj": linear(sd, f"{bp}.attn.proj"),
            },
            "norm2": layer_norm(sd, f"{bp}.norm2"),
            "mlp_fc1": linear(sd, f"{bp}.mlp.fc1"),
            "mlp_fc2": linear(sd, f"{bp}.mlp.fc2"),
        }
    return params, {}


# ---------------------------------------------------------------------------
# Fusion encoder / geometry / decoder / seg head / scoring
# ---------------------------------------------------------------------------


def _fusion_layer(sd, p):
    return {
        "self_attn": mha(sd, f"{p}.self_attn"),
        "cross_attn_image": mha(sd, f"{p}.cross_attn_image"),
        "linear1": linear(sd, f"{p}.linear1"),
        "linear2": linear(sd, f"{p}.linear2"),
        "norm1": layer_norm(sd, f"{p}.norm1"),
        "norm2": layer_norm(sd, f"{p}.norm2"),
        "norm3": layer_norm(sd, f"{p}.norm3"),
    }


def convert_fusion_encoder(sd, p, num_layers=6):
    """reference encoder.py TransformerEncoderFusion -> FusionEncoder."""
    return (
        {f"layers_{i}": _fusion_layer(sd, f"{p}.layers.{i}") for i in range(num_layers)},
        {},
    )


def convert_geometry_encoder(sd, p, num_layers=3):
    """reference geometry_encoders.py SequenceGeometryEncoder."""
    params = {
        "label_embed": embed(sd, f"{p}.label_embed"),
        "cls_embed": embed(sd, f"{p}.cls_embed"),
        "points_direct_project": linear(sd, f"{p}.points_direct_project"),
        "points_pool_project": linear(sd, f"{p}.points_pool_project"),
        "points_pos_enc_project": linear(sd, f"{p}.points_pos_enc_project"),
        "boxes_direct_project": linear(sd, f"{p}.boxes_direct_project"),
        "boxes_pool_project": conv(sd, f"{p}.boxes_pool_project"),
        "boxes_pos_enc_project": linear(sd, f"{p}.boxes_pos_enc_project"),
        "final_proj": linear(sd, f"{p}.final_proj"),
        "norm": layer_norm(sd, f"{p}.norm"),
        "img_pre_norm": layer_norm(sd, f"{p}.img_pre_norm"),
        "encode_norm": layer_norm(sd, f"{p}.encode_norm"),
    }
    for i in range(num_layers):
        params[f"encode_{i}"] = _fusion_layer(sd, f"{p}.encode.{i}")
    return params, {}


def convert_decoder(sd, p, num_layers=6):
    """reference decoder.py TransformerDecoder -> TransformerDecoder."""
    params = {
        "query_embed": embed(sd, f"{p}.query_embed"),
        "reference_points": embed(sd, f"{p}.reference_points"),
        "norm": layer_norm(sd, f"{p}.norm"),
        "bbox_embed": mlp(sd, f"{p}.bbox_embed", 3),
        "ref_point_head": mlp(sd, f"{p}.ref_point_head", 2),
        "boxRPB_embed_x": mlp(sd, f"{p}.boxRPB_embed_x", 2),
        "boxRPB_embed_y": mlp(sd, f"{p}.boxRPB_embed_y", 2),
        "presence_token_embed": embed(sd, f"{p}.presence_token"),
        "presence_token_head": mlp(sd, f"{p}.presence_token_head", 3),
        "presence_token_out_norm": layer_norm(sd, f"{p}.presence_token_out_norm"),
    }
    for i in range(num_layers):
        lp = f"{p}.layers.{i}"
        params[f"layers_{i}"] = {
            "self_attn": mha(sd, f"{lp}.self_attn"),
            "cross_attn": mha(sd, f"{lp}.cross_attn"),
            "ca_text": mha(sd, f"{lp}.ca_text"),
            "norm1": layer_norm(sd, f"{lp}.norm1"),
            "norm2": layer_norm(sd, f"{lp}.norm2"),
            "norm3": layer_norm(sd, f"{lp}.norm3"),
            "catext_norm": layer_norm(sd, f"{lp}.catext_norm"),
            "linear1": linear(sd, f"{lp}.linear1"),
            "linear2": linear(sd, f"{lp}.linear2"),
        }
    return params, {}


def convert_seg_head(sd, p, num_stages=2):
    """reference maskformer_segmentation.py UniversalSegmentationHead.

    NOTE: the torch pixel decoder builds 3 conv stages but only 2 execute
    for the 3-level FPN (maskformer_segmentation.py:203-219); stage index 2
    is dead weight and intentionally skipped.
    """
    pd = {}
    for i in range(num_stages):
        pd[f"conv_layers_{i}"] = conv(sd, f"{p}.pixel_decoder.conv_layers.{i}")
        pd[f"norms_{i}"] = layer_norm(sd, f"{p}.pixel_decoder.norms.{i}")
    params = {
        "pixel_decoder": pd,
        "cross_attn_norm": layer_norm(sd, f"{p}.cross_attn_norm"),
        "cross_attend_prompt": mha(sd, f"{p}.cross_attend_prompt"),
        "instance_seg_head": conv(sd, f"{p}.instance_seg_head"),
        "semantic_seg_head": conv(sd, f"{p}.semantic_seg_head"),
        "mask_embed": mlp(sd, f"{p}.mask_predictor.mask_embed", 3),
    }
    return params, {}


def convert_scoring(sd, p):
    """reference model_misc.py DotProductScoring."""
    return (
        {
            "prompt_mlp": {
                **mlp(sd, f"{p}.prompt_mlp", 2),
                "out_norm_ln": layer_norm(sd, f"{p}.prompt_mlp.out_norm"),
            },
            "prompt_proj": linear(sd, f"{p}.prompt_proj"),
            "hs_proj": linear(sd, f"{p}.hs_proj"),
        },
        {},
    )


# ---------------------------------------------------------------------------
# Tracker core
# ---------------------------------------------------------------------------


def convert_memory_attention(sd, p, num_layers=4):
    params = {"norm": layer_norm(sd, f"{p}.norm")}
    for i in range(num_layers):
        lp = f"{p}.layers.{i}"
        params[f"layers_{i}"] = {
            "self_attn": sam_attention(sd, f"{lp}.self_attn"),
            "cross_attn_image": sam_attention(sd, f"{lp}.cross_attn_image"),
            "norm1": layer_norm(sd, f"{lp}.norm1"),
            "norm2": layer_norm(sd, f"{lp}.norm2"),
            "norm3": layer_norm(sd, f"{lp}.norm3"),
            "linear1": linear(sd, f"{lp}.linear1"),
            "linear2": linear(sd, f"{lp}.linear2"),
        }
    return params, {}


def convert_memory_encoder(sd, p, num_down_layers=4, num_fusers=2):
    params = {"pix_feat_proj": conv(sd, f"{p}.pix_feat_proj")}
    md = {}
    for i in range(num_down_layers):
        md[f"encoder_{i}"] = conv(sd, f"{p}.mask_downsampler.encoder.{3 * i}")
        md[f"encoder_ln_{i}"] = layer_norm_2d(
            sd, f"{p}.mask_downsampler.encoder.{3 * i + 1}"
        )
    md["encoder_out"] = conv(sd, f"{p}.mask_downsampler.encoder.{3 * num_down_layers}")
    params["mask_downsampler"] = md
    for i in range(num_fusers):
        fp = f"{p}.fuser.layers.{i}"
        params[f"fuser_{i}"] = {
            "dwconv": conv(sd, f"{fp}.dwconv"),
            "norm": layer_norm_2d(sd, f"{fp}.norm"),
            "pwconv1": linear(sd, f"{fp}.pwconv1"),
            "pwconv2": linear(sd, f"{fp}.pwconv2"),
            "gamma": _np(sd[f"{fp}.gamma"]),
        }
    params["out_proj"] = conv(sd, f"{p}.out_proj")
    return params, {}


def convert_tracker_core(sd, p="inst_interactive_predictor.model"):
    """reference Sam3TrackerBase subtree -> video/tracker.TrackerCore."""
    params = {
        "memory_attention": convert_memory_attention(
            sd, f"{p}.transformer.encoder"
        )[0],
        "memory_encoder": convert_memory_encoder(sd, f"{p}.maskmem_backbone")[0],
        "sam_prompt_encoder": convert_prompt_encoder(sd, f"{p}.sam_prompt_encoder"),
        "sam_mask_decoder": convert_mask_decoder(sd, f"{p}.sam_mask_decoder"),
        "obj_ptr_proj": mlp(sd, f"{p}.obj_ptr_proj", 3),
        "obj_ptr_tpos_proj": linear(sd, f"{p}.obj_ptr_tpos_proj"),
        "mask_downsample": conv(sd, f"{p}.mask_downsample"),
        "maskmem_tpos_enc": _np(sd[f"{p}.maskmem_tpos_enc"]).reshape(7, 1, 1, -1),
        "no_mem_embed": _np(sd[f"{p}.no_mem_embed"]).reshape(1, 1, -1),
        "no_mem_pos_enc": _np(sd[f"{p}.no_mem_pos_enc"]).reshape(1, 1, -1),
        "no_obj_ptr": _np(sd[f"{p}.no_obj_ptr"]),
        "no_obj_embed_spatial": _np(sd[f"{p}.no_obj_embed_spatial"]),
    }
    return params, {}


# ---------------------------------------------------------------------------
# Full image model
# ---------------------------------------------------------------------------

BACKBONE_DEPTHS = {
    "efficientvit": {"b0": (1, 2, 2, 2, 2), "b1": (1, 2, 3, 3, 4), "b2": (1, 3, 4, 4, 6)},
}


def convert_image_model(
    sd: dict,
    backbone_type: str = "efficientvit",
    model_name: str = "b1",
    text_encoder_type=None,
    add_sam2_neck: bool = False,
):
    """Compose a full Sam3ImageModel param tree from a cleaned reference
    state_dict (utils/checkpoint.clean_reference_state_dict output)."""
    from efficientsam3_tpu_torch.models.mobile_clip import MOBILECLIP_TEXT_CFGS

    params, stats = {}, {}
    tp = "backbone.vision_backbone.trunk.model"
    if backbone_type == "efficientvit":
        bb_p, bb_s = cb.convert_efficientvit(
            sd, f"{tp}.backbone.model", BACKBONE_DEPTHS["efficientvit"][model_name]
        )
    elif backbone_type == "repvit":
        from efficientsam3_tpu_torch.models.repvit import _m0_9_cfgs, _m1_1_cfgs, _m2_3_cfgs

        cfgs = {"m0.9": _m0_9_cfgs, "m1.1": _m1_1_cfgs, "m2.3": _m2_3_cfgs}[model_name]()
        bb_p, bb_s = cb.convert_repvit(sd, f"{tp}.backbone.model", cfgs)
    elif backbone_type == "tinyvit":
        bb_p, bb_s = cb.convert_tinyvit(sd, f"{tp}.backbone.model")
    else:
        raise ValueError(backbone_type)
    hp, hs = cb.convert_student_head(sd, f"{tp}.head")
    params["trunk"] = {"trunk": bb_p, "head": hp}
    stats["trunk"] = {"trunk": bb_s, "head": hs}

    sam3_neck, _ = cb.convert_fpn_neck(sd, "backbone.vision_backbone.convs")
    params["neck"] = {"sam3": sam3_neck}
    if add_sam2_neck:
        sam2_neck, _ = cb.convert_fpn_neck(sd, "backbone.vision_backbone.sam2_convs")
        params["neck"]["sam2"] = sam2_neck

    lp = "backbone.language_backbone"
    if text_encoder_type is None:
        te_p, te_s = convert_ve_text_encoder(sd, lp)
    else:
        cfg = MOBILECLIP_TEXT_CFGS[text_encoder_type]
        te_p, te_s = convert_mobileclip_text(sd, lp, cfg["layers"], cfg["variant"])
    params["text_encoder"] = te_p
    if te_s:
        stats["text_encoder"] = te_s

    params["geometry_encoder"], _ = convert_geometry_encoder(sd, "geometry_encoder")
    params["fusion_encoder"], _ = convert_fusion_encoder(sd, "transformer.encoder")
    params["decoder"], _ = convert_decoder(sd, "transformer.decoder")
    params["seg_head"], _ = convert_seg_head(sd, "segmentation_head")
    params["scoring"], _ = convert_scoring(sd, "dot_prod_scoring")
    return params, stats
