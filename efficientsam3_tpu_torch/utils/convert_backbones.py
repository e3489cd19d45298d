"""torch -> flax converters for student backbones, projection head, necks.

The port's copy of efficientsam3_tpu/utils/convert_backbones.py (numpy
only).

Torch key layouts follow the reference modules:
  EfficientViT: sam3/backbones/efficientvit/efficientvit/backbone.py
    (OpSequential stores children under `op_list`, residuals under `main`)
  RepViT: sam3/backbones/repvit.py (features.{i}, token_mixer/channel_mixer)
  TinyViT: sam3/backbones/tiny_vit.py (patch_embed.seq, layers.{i}.blocks)
  Student head: model_builder.py:764 ImageStudentEncoder (head.0/1/3)
  Neck: model/necks.py:13 (convs.{i}.<named Sequential children>)

Every converter returns (params, batch_stats) nested dicts (numpy leaves).
"""

from __future__ import annotations

from efficientsam3_tpu_torch.utils.torch_convert import _np, batch_norm, conv, conv_transpose, layer_norm, linear


def _put(params, stats, name, sub):
    sp, ss = sub
    params[name] = sp
    if ss:
        stats[name] = ss
    return params, stats


def conv_norm_act(sd, p):
    """EfficientViT ConvLayer -> my ConvNormAct {conv, norm}."""
    params = {"conv": conv(sd, f"{p}.conv")}
    stats = {}
    if f"{p}.norm.weight" in sd:
        bnp, bns = batch_norm(sd, f"{p}.norm")
        params["norm"] = bnp
        stats["norm"] = bns
    return params, stats


def evit_dsconv(sd, p):
    params, stats = {}, {}
    _put(params, stats, "depth_conv", conv_norm_act(sd, f"{p}.depth_conv"))
    _put(params, stats, "point_conv", conv_norm_act(sd, f"{p}.point_conv"))
    return params, stats


def evit_mbconv(sd, p):
    params, stats = {}, {}
    _put(params, stats, "inverted_conv", conv_norm_act(sd, f"{p}.inverted_conv"))
    _put(params, stats, "depth_conv", conv_norm_act(sd, f"{p}.depth_conv"))
    _put(params, stats, "point_conv", conv_norm_act(sd, f"{p}.point_conv"))
    return params, stats


def evit_litemla(sd, p, num_scales=1):
    params, stats = {}, {}
    _put(params, stats, "qkv", conv_norm_act(sd, f"{p}.qkv"))
    for i in range(num_scales):
        params[f"aggreg_{i}_dw"] = conv(sd, f"{p}.aggreg.{i}.0")
        params[f"aggreg_{i}_pw"] = conv(sd, f"{p}.aggreg.{i}.1")
    _put(params, stats, "proj", conv_norm_act(sd, f"{p}.proj"))
    return params, stats


def convert_efficientvit(sd, p, depth_list):
    """EfficientViTBackbone torch tree -> my EfficientViTBackbone tree."""
    params, stats = {}, {}
    d = depth_list
    _put(params, stats, "stem_conv", conv_norm_act(sd, f"{p}.input_stem.op_list.0"))
    for i in range(d[0]):
        _put(
            params, stats, f"stem_block_{i}",
            evit_dsconv(sd, f"{p}.input_stem.op_list.{1 + i}.main"),
        )
    for s in (1, 2):  # MBConv stages: torch stages.{s-1}
        for i in range(d[s]):
            _put(
                params, stats, f"stage{s}_block_{i}",
                evit_mbconv(sd, f"{p}.stages.{s - 1}.op_list.{i}.main"),
            )
    for s in (3, 4):  # attention stages: torch stages.{s-1}
        tp = f"{p}.stages.{s - 1}"
        _put(params, stats, f"stage{s}_down", evit_mbconv(sd, f"{tp}.op_list.0.main"))
        for i in range(d[s]):
            bp = f"{tp}.op_list.{1 + i}"
            blk_p, blk_s = {}, {}
            _put(
                blk_p, blk_s, "context_module",
                evit_litemla(sd, f"{bp}.context_module.main"),
            )
            _put(
                blk_p, blk_s, "local_module",
                evit_mbconv(sd, f"{bp}.local_module.main"),
            )
            params[f"stage{s}_block_{i}"] = blk_p
            stats[f"stage{s}_block_{i}"] = blk_s
    return params, stats


# --------------------------------------------------------------------------
# RepViT
# --------------------------------------------------------------------------


def conv_bn(sd, p):
    """Conv2d_BN -> my ConvBN {c, bn}."""
    bnp, bns = batch_norm(sd, f"{p}.bn")
    return {"c": conv(sd, f"{p}.c"), "bn": bnp}, {"bn": bns}


def se_block(sd, p):
    return {"fc1": conv(sd, f"{p}.fc1"), "fc2": conv(sd, f"{p}.fc2")}, {}


def convert_repvit(sd, p, cfgs):
    """RepViT torch `features.{i}` tree -> my RepViT tree (train form)."""
    params, stats = {}, {}
    _put(params, stats, "patch_embed_0", conv_bn(sd, f"{p}.features.0.0"))
    _put(params, stats, "patch_embed_1", conv_bn(sd, f"{p}.features.0.2"))
    for i, (c, use_se, s) in enumerate(cfgs):
        tp = f"{p}.features.{i + 1}"
        bp, bs = {}, {}
        if s == 2:
            _put(bp, bs, "tm_dw", conv_bn(sd, f"{tp}.token_mixer.0"))
            if use_se:
                _put(bp, bs, "tm_se", se_block(sd, f"{tp}.token_mixer.1"))
            _put(bp, bs, "tm_pw", conv_bn(sd, f"{tp}.token_mixer.2"))
        else:
            rp, rs = {}, {}
            _put(rp, rs, "conv", conv_bn(sd, f"{tp}.token_mixer.0.conv"))
            rp["conv1"] = conv(sd, f"{tp}.token_mixer.0.conv1")
            bnp, bns = batch_norm(sd, f"{tp}.token_mixer.0.bn")
            rp["bn"] = bnp
            rs["bn"] = bns
            bp["tm_repvgg"] = rp
            bs["tm_repvgg"] = rs
            if use_se:
                _put(bp, bs, "tm_se", se_block(sd, f"{tp}.token_mixer.1"))
        _put(bp, bs, "cm_expand", conv_bn(sd, f"{tp}.channel_mixer.m.0"))
        _put(bp, bs, "cm_project", conv_bn(sd, f"{tp}.channel_mixer.m.2"))
        params[f"blocks_{i}"] = bp
        stats[f"blocks_{i}"] = bs
    return params, stats


# --------------------------------------------------------------------------
# TinyViT
# --------------------------------------------------------------------------


def _tv_attn(sd, p):
    return {
        "norm": layer_norm(sd, f"{p}.norm"),
        "qkv": linear(sd, f"{p}.qkv"),
        "proj": linear(sd, f"{p}.proj"),
        "attention_biases": _np(sd[f"{p}.attention_biases"]),
    }, {}


def convert_tinyvit(sd, p, depths=(2, 2, 6, 2)):
    params, stats = {}, {}
    _put(params, stats, "patch_embed_0", conv_bn(sd, f"{p}.patch_embed.seq.0"))
    _put(params, stats, "patch_embed_1", conv_bn(sd, f"{p}.patch_embed.seq.2"))
    for stage in range(len(depths)):
        for i in range(depths[stage]):
            tp = f"{p}.layers.{stage}.blocks.{i}"
            bp, bs = {}, {}
            if stage == 0:
                for cn in ("conv1", "conv2", "conv3"):
                    _put(bp, bs, cn, conv_bn(sd, f"{tp}.{cn}"))
            else:
                _put(bp, bs, "attn", _tv_attn(sd, f"{tp}.attn"))
                _put(bp, bs, "local_conv", conv_bn(sd, f"{tp}.local_conv"))
                bp["mlp_norm"] = layer_norm(sd, f"{tp}.mlp.norm")
                bp["mlp_fc1"] = linear(sd, f"{tp}.mlp.fc1")
                bp["mlp_fc2"] = linear(sd, f"{tp}.mlp.fc2")
            params[f"stage{stage}_block_{i}"] = bp
            if bs:
                stats[f"stage{stage}_block_{i}"] = bs
        if stage < len(depths) - 1:
            dp, ds = {}, {}
            for cn in ("conv1", "conv2", "conv3"):
                _put(dp, ds, cn, conv_bn(sd, f"{p}.layers.{stage}.downsample.{cn}"))
            params[f"downsample_{stage}"] = dp
            stats[f"downsample_{stage}"] = ds
    return params, stats


# --------------------------------------------------------------------------
# Student projection head + FPN neck
# --------------------------------------------------------------------------


def convert_student_head(sd, p):
    """ImageStudentEncoder.head (model_builder.py:770-775)."""
    bnp, bns = batch_norm(sd, f"{p}.1")
    return (
        {"head_0": conv(sd, f"{p}.0"), "head_1": bnp, "head_3": conv(sd, f"{p}.3")},
        {"head_1": bns},
    )


def convert_fpn_neck(sd, p, scale_factors=(4.0, 2.0, 1.0, 0.5)):
    """One Sam3DualViTDetNeck conv list (necks.py:40-93) -> SimpleFPNNeck."""
    params = {}
    for i, s in enumerate(scale_factors):
        tp = f"{p}.{i}"
        branch = {}
        if s == 4.0:
            branch["dconv_0"] = conv_transpose(sd, f"{tp}.dconv_2x2_0")
            branch["dconv_1"] = conv_transpose(sd, f"{tp}.dconv_2x2_1")
        elif s == 2.0:
            branch["dconv_0"] = conv_transpose(sd, f"{tp}.dconv_2x2")
        branch["conv_1x1"] = conv(sd, f"{tp}.conv_1x1")
        branch["conv_3x3"] = conv(sd, f"{tp}.conv_3x3")
        params[f"convs_{i}"] = branch
    return params, {}
