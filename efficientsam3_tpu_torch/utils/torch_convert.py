"""torch state_dict -> flax params conversion.

The port's copy of efficientsam3_tpu/utils/torch_convert.py (numpy only):
the reference checkpoint's leaves in the flax layout, which
``utils/convert.convert_variables`` then carries into the port's
state_dict (``utils/checkpoint.load_reference_checkpoint``).

Converts reference checkpoints (facebook/sam3 `sam3.pt`, EfficientSAM3 `.pt`
files; key layout per reference sam3/sam3/model_builder.py:584-631) into this
framework's param trees. Leaf rules:

  Linear            (O, I) weight        -> kernel (I, O), bias
  Conv2d            (O, I, kh, kw)       -> kernel (kh, kw, I, O), bias
  ConvTranspose2d   (I, O, kh, kw)       -> kernel flip(kh, kw) -> (kh, kw, I, O)
  LayerNorm         weight/bias          -> scale/bias
  Embedding         (N, C)               -> embedding
  BatchNorm2d       weight/bias/mean/var -> scale/bias + batch_stats
  MultiheadAttention in_proj (3E, E)     -> split q/k/v + out_proj

All outputs are numpy arrays (device placement happens at load).
"""

from __future__ import annotations

import numpy as np


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def linear(sd, p):
    out = {"kernel": _np(sd[f"{p}.weight"]).T}
    if f"{p}.bias" in sd:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def conv(sd, p):
    out = {"kernel": _np(sd[f"{p}.weight"]).transpose(2, 3, 1, 0)}
    if f"{p}.bias" in sd:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def conv_transpose(sd, p):
    w = _np(sd[f"{p}.weight"])  # (I, O, kh, kw)
    out = {"kernel": w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy()}
    if f"{p}.bias" in sd:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def layer_norm(sd, p):
    return {"scale": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


def layer_norm_2d(sd, p):
    """Our LayerNorm2d keeps torch names (weight/bias)."""
    return {"weight": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


def embed(sd, p):
    return {"embedding": _np(sd[f"{p}.weight"])}


def mha(sd, p):
    """torch nn.MultiheadAttention -> our MultiheadAttention params."""
    w = _np(sd[f"{p}.in_proj_weight"])
    b = _np(sd[f"{p}.in_proj_bias"])
    e = w.shape[1]
    return {
        "q_proj": {"kernel": w[:e].T, "bias": b[:e]},
        "k_proj": {"kernel": w[e : 2 * e].T, "bias": b[e : 2 * e]},
        "v_proj": {"kernel": w[2 * e :].T, "bias": b[2 * e :]},
        "out_proj": linear(sd, f"{p}.out_proj"),
    }


def batch_norm(sd, p):
    """Returns (params, batch_stats) for flax nn.BatchNorm."""
    params = {"scale": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}
    stats = {
        "mean": _np(sd[f"{p}.running_mean"]),
        "var": _np(sd[f"{p}.running_var"]),
    }
    return params, stats


def sam_attention(sd, p):
    """reference sam/transformer.py Attention: separate q/k/v/out linears."""
    return {
        "q_proj": linear(sd, f"{p}.q_proj"),
        "k_proj": linear(sd, f"{p}.k_proj"),
        "v_proj": linear(sd, f"{p}.v_proj"),
        "out_proj": linear(sd, f"{p}.out_proj"),
    }


def mlp(sd, p, num_layers, torch_list="layers"):
    """reference MLP (mask_decoder.py:297 / model_misc.py:160)."""
    out = {}
    for i in range(num_layers):
        out[f"layers_{i}"] = linear(sd, f"{p}.{torch_list}.{i}")
    return out


def mlp_block(sd, p):
    return {"lin1": linear(sd, f"{p}.lin1"), "lin2": linear(sd, f"{p}.lin2")}


# ---------------------------------------------------------------------------
# SAM heads
# ---------------------------------------------------------------------------


def convert_prompt_encoder(sd, p="sam_prompt_encoder"):
    out = {
        "pe_layer": {
            "positional_encoding_gaussian_matrix": _np(
                sd[f"{p}.pe_layer.positional_encoding_gaussian_matrix"]
            )
        },
        "not_a_point_embed": embed(sd, f"{p}.not_a_point_embed"),
        "no_mask_embed": embed(sd, f"{p}.no_mask_embed"),
        "mask_down_0": conv(sd, f"{p}.mask_downscaling.0"),
        "mask_down_ln0": layer_norm_2d(sd, f"{p}.mask_downscaling.1"),
        "mask_down_1": conv(sd, f"{p}.mask_downscaling.3"),
        "mask_down_ln1": layer_norm_2d(sd, f"{p}.mask_downscaling.4"),
        "mask_down_2": conv(sd, f"{p}.mask_downscaling.6"),
    }
    for i in range(4):
        out[f"point_embeddings_{i}"] = embed(sd, f"{p}.point_embeddings.{i}")
    return out


def convert_two_way_transformer(sd, p, depth=2):
    out = {}
    for i in range(depth):
        lp = f"{p}.layers.{i}"
        out[f"layers_{i}"] = {
            "self_attn": sam_attention(sd, f"{lp}.self_attn"),
            "norm1": layer_norm(sd, f"{lp}.norm1"),
            "cross_attn_token_to_image": sam_attention(
                sd, f"{lp}.cross_attn_token_to_image"
            ),
            "norm2": layer_norm(sd, f"{lp}.norm2"),
            "mlp": mlp_block(sd, f"{lp}.mlp"),
            "norm3": layer_norm(sd, f"{lp}.norm3"),
            "cross_attn_image_to_token": sam_attention(
                sd, f"{lp}.cross_attn_image_to_token"
            ),
            "norm4": layer_norm(sd, f"{lp}.norm4"),
        }
    out["final_attn_token_to_image"] = sam_attention(sd, f"{p}.final_attn_token_to_image")
    out["norm_final_attn"] = layer_norm(sd, f"{p}.norm_final_attn")
    return out


def convert_mask_decoder(
    sd,
    p="sam_mask_decoder",
    num_mask_tokens=4,
    use_high_res_features=True,
    pred_obj_scores=True,
    pred_obj_scores_mlp=True,
    transformer_depth=2,
):
    out = {
        "transformer": convert_two_way_transformer(
            sd, f"{p}.transformer", transformer_depth
        ),
        "iou_token": embed(sd, f"{p}.iou_token"),
        "mask_tokens": embed(sd, f"{p}.mask_tokens"),
        "output_upscaling_0": conv_transpose(sd, f"{p}.output_upscaling.0"),
        "output_upscaling_ln": layer_norm_2d(sd, f"{p}.output_upscaling.1"),
        "output_upscaling_1": conv_transpose(sd, f"{p}.output_upscaling.3"),
        "iou_prediction_head": mlp(sd, f"{p}.iou_prediction_head", 3),
    }
    if pred_obj_scores:
        out["obj_score_token"] = embed(sd, f"{p}.obj_score_token")
        if pred_obj_scores_mlp:
            out["pred_obj_score_head"] = mlp(sd, f"{p}.pred_obj_score_head", 3)
        else:
            out["pred_obj_score_head"] = linear(sd, f"{p}.pred_obj_score_head")
    if use_high_res_features:
        out["conv_s0"] = conv(sd, f"{p}.conv_s0")
        out["conv_s1"] = conv(sd, f"{p}.conv_s1")
    for i in range(num_mask_tokens):
        out[f"output_hypernetworks_mlps_{i}"] = mlp(
            sd, f"{p}.output_hypernetworks_mlps.{i}", 3
        )
    return out
