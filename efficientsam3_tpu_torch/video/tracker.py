"""SAM2-style streaming-memory tracker core (device side).

Counterpart of efficientsam3_tpu/video/tracker.py: 72x72 tokens at
d_model 256, num_maskmem 7, a 64-dim memory space, 4-layer RoPE memory
attention, the SAM prompt encoder and mask decoder, object pointers (each
split into 4 tokens of 64), no-object embeddings and sigmoid(mask) * 20 -
10 memory encoding. The object axis is the batch axis: all object slots of
a frame step together, and the memory bank has a fixed width with its
invalid entries masked.

  - ``condition_features``: memory attention over the bank, projected per
    frame (the plain path);
  - ``encode_memory_kv`` / ``tpos_k_delta`` / ``condition_features_cached``:
    the cached path, where each bank entry's keys are projected once and
    aged by an additive rotated delta;
  - ``forward_sam_heads`` / ``use_mask_as_output``: prompt encoder and mask
    decoder on the conditioned features;
  - ``encode_memory``: memory encoder + no-object spatial embedding.

Training mode (``.train()``, each JAX ``train=True`` argument): dropout
in the memory attention and no dynamic multimask choice in the mask
decoder. On CUDA ``no_mem_features``, ``condition_features`` (the plain
path: ``flash_sdpa`` at head dim 256 for self- and cross-attention, with
its backward kernels), ``forward_sam_heads`` and ``encode_memory``
(``depthwise_conv2d`` with its backward) run under autograd, over memories
stacked by the caller, as the JAX ``condition_features`` does.
``condition_features_cached`` takes training mode too, but under autograd
it raises in ``flash_memattn`` / ``flash_memattn_q8``, which have no
backward (nor in JAX). ``video.predictor.TrackerPredictor`` stays an
inference API: it rewrites its flat bank in place.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from efficientsam3_tpu_torch.models.common import (
    MLP,
    Conv,
    Dense,
    apply_rope,
    sine_pos_embed_2d,
)
from efficientsam3_tpu_torch.models.memory_attention import MemoryAttention
from efficientsam3_tpu_torch.models.memory_encoder import MemoryEncoder
from efficientsam3_tpu_torch.models.sam import MaskDecoder, PromptEncoder
from efficientsam3_tpu_torch.ops.flash_attention import padded_bank_len, quantize_rows
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear

NO_OBJ_SCORE = -1024.0


def get_1d_sine_pe(pos, dim: int, temperature: float = 10000.0):
    """(..., dim) sine/cosine embedding of scalar positions."""
    half = dim // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)
    pe = pos[..., None] / dim_t
    return torch.cat([torch.sin(pe), torch.cos(pe)], dim=-1)


class TrackerCore(nn.Module):
    """Device-side tracker: memory attention + SAM heads + memory encoder."""

    def __init__(self, image_size: int = 1008, backbone_stride: int = 14, d_model: int = 256,
                 mem_dim: int = 64, num_maskmem: int = 7, max_obj_ptrs: int = 16,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.image_size = image_size
        self.feat_size = image_size // backbone_stride  # 72
        self.low_res_mask_size = self.feat_size * 4  # 288
        self.d_model = d_model
        self.mem_dim = mem_dim
        self.num_maskmem = num_maskmem
        self.max_obj_ptrs = max_obj_ptrs
        self.sigmoid_scale_for_mem_enc = 20.0
        self.sigmoid_bias_for_mem_enc = -10.0
        d, md, fs = d_model, mem_dim, self.feat_size
        self.memory_attention = MemoryAttention(d_model=d, kv_in_dim=md, dropout=dropout,
                                                dtype=dtype)
        interp = fs * 16  # 1152 at 1008 / 14
        self.memory_encoder = MemoryEncoder(out_dim=md, in_dim=d, interpol_size=(interp, interp),
                                            dtype=dtype)
        self.sam_prompt_encoder = PromptEncoder(d, (fs, fs), (image_size, image_size))
        self.sam_mask_decoder = MaskDecoder(transformer_dim=d, dtype=dtype)
        self.obj_ptr_proj = MLP(d, d, d, 3)
        self.obj_ptr_tpos_proj = Dense(d, md)
        self.mask_downsample = Conv(1, 1, 4, stride=4)
        self.maskmem_tpos_enc = nn.Parameter(torch.empty(num_maskmem, 1, 1, md))
        self.no_mem_embed = nn.Parameter(torch.empty(1, 1, d))
        self.no_mem_pos_enc = nn.Parameter(torch.empty(1, 1, d))
        self.no_obj_ptr = nn.Parameter(torch.empty(1, d))
        self.no_obj_embed_spatial = nn.Parameter(torch.empty(1, md))

    # ------------------------------------------------------------------

    def no_mem_features(self, vision_tokens):
        """First / prompted-frame path: add no_mem_embed."""
        return vision_tokens + self.no_mem_embed[0]

    def _ptr_tokens(self, obj_ptrs, ptr_tdiff, ptr_valid, max_tdiff):
        """Object pointers -> (tokens (B, n_ptr*split, md), their positions,
        their PAD mask): each pointer splits into d_model / mem_dim tokens."""
        b, n_ptr = obj_ptrs.shape[:2]
        split = self.d_model // self.mem_dim
        ptr_tok = obj_ptrs.reshape(b, n_ptr * split, self.mem_dim)
        tpe = get_1d_sine_pe(ptr_tdiff / max(max_tdiff - 1.0, 1.0), self.d_model)
        ptr_pos = self.obj_ptr_tpos_proj(tpe).repeat_interleave(split, dim=1)
        ptr_mask = ~ptr_valid.repeat_interleave(split, dim=1)
        return ptr_tok, ptr_pos, ptr_mask

    def condition_features(self, vision_tokens, vision_pos, mem_feats, mem_tpos_idx, mem_valid,
                           obj_ptrs, ptr_tdiff, ptr_valid, max_tdiff: float = 16.0):
        """Memory attention over a fixed-width bank, projected per frame.

        vision_tokens (B, HW, C); vision_pos (HW, C); mem_feats (B, n_mem,
        Hm, Wm, mem_dim); mem_tpos_idx (B, n_mem) int; mem_valid (B, n_mem)
        bool; obj_ptrs (B, n_ptr, C); ptr_tdiff (B, n_ptr) frame distances;
        ptr_valid (B, n_ptr) bool."""
        b, n_mem, hm, wm, md = mem_feats.shape
        spatial_pos = sine_pos_embed_2d(hm, wm, md, device=mem_feats.device)
        tpos = self.maskmem_tpos_enc[self.num_maskmem - 1 - mem_tpos_idx]  # (B, n_mem, 1, 1, md)
        mem_pos = (spatial_pos[None, None] + tpos).reshape(b, n_mem * hm * wm, md)
        mem_tok = mem_feats.reshape(b, n_mem * hm * wm, md)
        mem_mask = ~mem_valid.repeat_interleave(hm * wm, dim=1)
        ptr_tok, ptr_pos, ptr_mask = self._ptr_tokens(obj_ptrs, ptr_tdiff, ptr_valid, max_tdiff)
        return self.memory_attention(
            vision_tokens, vision_pos, torch.cat([mem_tok, ptr_tok], dim=1),
            torch.cat([mem_pos, ptr_pos], dim=1), torch.cat([mem_mask, ptr_mask], dim=1),
            num_obj_ptr_tokens=ptr_tok.shape[1])

    # -------- cached-bank path -------------------------------------------

    def encode_memory_kv(self, mem):
        """Per-layer cached keys of one memory entry, and its raw values.

        mem (B, Hm, Wm, mem_dim) from encode_memory. Returns (k (L, B,
        Hm*Wm, C), v_raw (B, Hm*Wm, mem_dim)): k carries the spatial sine
        pos and the rotary encoding, not the slot-age embedding (added at
        attend time, tpos_k_delta). v_raw is the memory tokens in the keys'
        dtype: the bf16 attention kernel reads bf16 values (the JAX package
        keeps them fp32)."""
        b, hm, wm, md = mem.shape
        s_e = hm * wm
        pos = sine_pos_embed_2d(hm, wm, md, device=mem.device).reshape(s_e, md)
        k = self.memory_attention.project_bank_entry(mem.reshape(b, s_e, md), pos, s_e)
        return k[:, :, 0], mem.reshape(b, s_e, md).to(k.dtype)

    def tpos_k_delta(self):
        """Rotated per-layer images of the slot-age embeddings, (L,
        num_maskmem, Hm*Wm, C): k_proj is affine, so k(entry + pos + tpos) =
        k(entry + pos) + rope(k_proj(tpos) - k_proj(0))."""
        s_e = self.feat_size ** 2
        tpos = self.maskmem_tpos_enc[:, 0, 0, :]
        deltas = []
        for layer in self.memory_attention.layers:
            att = layer.cross_attn_image
            w = att.k_proj(tpos) - att.k_proj(torch.zeros_like(tpos))
            cos, sin = att._rope_tables(s_e, w.device)
            deltas.append(apply_rope(w[:, None, :].expand(w.shape[0], s_e, w.shape[-1]), cos, sin))
        return torch.stack(deltas)

    def condition_features_cached(self, vision_tokens, vision_pos, k_bank, v_bank, mem_tpos_idx,
                                  mem_valid, obj_ptrs, ptr_tdiff, ptr_valid, tpos_delta,
                                  max_tdiff: float = 16.0, shared_ages: bool = False,
                                  quantize_bank: bool = False):
        """condition_features over the cached bank.

        k_bank (L, B, S_pad, C) cached keys and v_bank (B, S_pad, mem_dim)
        raw tokens, flat and padded (flatten_kv_bank); tpos_delta from
        tpos_k_delta. Per layer the age deltas are added to the bank keys
        (the one pass over the bank a layer makes); the pointer tokens are
        projected per frame and attended as a second segment, merged by
        log-sum-exp. shared_ages: every slot holds the same frame in each
        bank column, so one age table serves all slots.

        quantize_bank (the opt-in int8 serving mode): each layer's
        age-adjusted keys are quantized per row (``quantize_rows``, plain
        tensor ops as in the JAX package) and attended by
        ``flash_memattn_q8`` on CUDA; the int8 copy lives for the layer
        only, the persistent bank stays in the compute dtype. Pad rows are
        zeros (scale eps / 127) and masked. Values, softmax and P V stay
        exact; the memory logits carry int8 rounding."""
        n_layers, b, s_pad, c = k_bank.shape
        n_mem = mem_valid.shape[1]
        s_e = tpos_delta.shape[2]
        s_tot = n_mem * s_e
        age = self.num_maskmem - 1 - mem_tpos_idx  # (B, n_mem)
        v_mem = v_bank[:, None]
        mem_mask = F.pad(~mem_valid.repeat_interleave(s_e, dim=1), (0, s_pad - s_tot),
                         value=True)
        ptr_tok, ptr_pos, ptr_mask = self._ptr_tokens(obj_ptrs, ptr_tdiff, ptr_valid, max_tdiff)
        n_ptr_tok = ptr_tok.shape[1]
        k_mem_layers, k_ptr_layers = [], []
        for li, layer in enumerate(self.memory_attention.layers):
            if shared_ages:
                d_one = tpos_delta[li][age[0]].reshape(s_tot, c).to(k_bank.dtype)
                k_adj = k_bank[li] + F.pad(d_one, (0, 0, 0, s_pad - s_tot))[None]
            else:
                d_sel = tpos_delta[li][age].reshape(b, s_tot, c).to(k_bank.dtype)
                k_adj = F.pad(k_bank[li, :, :s_tot] + d_sel, (0, 0, 0, s_pad - s_tot))
            if quantize_bank:
                k_i8, k_scale = quantize_rows(k_adj)
                k_mem_layers.append((k_i8[:, None], k_scale[:, None]))
            else:
                k_mem_layers.append(k_adj[:, None])
            k_in = ptr_tok + ptr_pos if layer.pos_enc_at_cross_attn_keys else ptr_tok
            k_ptr_layers.append(layer.cross_attn_image.project_k(k_in, s_e, n_ptr_tok))
        v_ptr = ptr_tok.to(v_mem.dtype)[:, None]
        return self.memory_attention.forward_cached(
            vision_tokens, vision_pos, k_mem_layers, v_mem, mem_mask, k_ptr_layers, v_ptr,
            ptr_mask)

    # ------------------------------------------------------------------

    def forward_sam_heads(self, pix_feat, point_coords, point_labels, high_res_features,
                          multimask_output: bool, mask_prompt=None):
        """pix_feat (B, Hf, Wf, C) conditioned features; point_coords (B, P, 2)
        pixel xy, point_labels (B, P) (-1 pads); high_res_features (s0, s1);
        mask_prompt (B, h, w, 1) low-res mask logits or None."""
        if mask_prompt is not None:
            need = 4 * self.feat_size
            if tuple(mask_prompt.shape[1:3]) != (need, need):
                # antialiased bilinear to the prompt encoder's input size
                mask_prompt = resize_bilinear(
                    mask_prompt.float().permute(0, 3, 1, 2), (need, need),
                    antialias=True).permute(0, 2, 3, 1)
        sparse, dense = self.sam_prompt_encoder(point_coords, point_labels, mask_prompt)
        image_pe = self.sam_prompt_encoder.dense_pe()
        multimasks, ious, sam_tokens, object_score_logits = self.sam_mask_decoder(
            pix_feat, image_pe, sparse, dense, multimask_output, high_res_features)
        is_obj = object_score_logits > 0  # (B, 1)
        multimasks = torch.where(is_obj[:, :, None, None], multimasks, NO_OBJ_SCORE).float()
        if multimask_output:
            best = ious.argmax(-1)
            idx = torch.arange(best.shape[0], device=best.device)
            low_res_masks = multimasks[idx, best][:, None]
            sam_token = sam_tokens[idx, best] if sam_tokens.shape[1] > 1 else sam_tokens[:, 0]
        else:
            low_res_masks = multimasks
            sam_token = sam_tokens[:, 0]
        high_res_masks = resize_bilinear(low_res_masks, (self.image_size, self.image_size))
        obj_ptr = self.obj_ptr_proj(sam_token)
        lam = is_obj.to(obj_ptr.dtype)
        obj_ptr = lam * obj_ptr + (1 - lam) * self.no_obj_ptr
        return {
            "low_res_multimasks": multimasks,
            "ious": ious,
            "low_res_masks": low_res_masks,  # (B, 1, 288, 288)
            "high_res_masks": high_res_masks,  # (B, 1, 1008, 1008)
            "obj_ptr": obj_ptr,  # (B, C)
            "object_score_logits": object_score_logits,  # (B, 1)
        }

    def use_mask_as_output(self, pix_feat, high_res_features, mask_inputs):
        """Adopt a given binary mask (B, Himg, Wimg, 1) as the output."""
        m = mask_inputs.float()
        b = m.shape[0]
        high_res_masks = (m * 20.0 - 10.0).permute(0, 3, 1, 2)
        lr = self.low_res_mask_size
        low_res_masks = resize_bilinear(high_res_masks, (lr, lr))
        heads = self.forward_sam_heads(
            pix_feat, torch.zeros((b, 1, 2), device=m.device),
            -torch.ones((b, 1), dtype=torch.long, device=m.device), high_res_features,
            multimask_output=False, mask_prompt=self.mask_downsample(m))
        lam = (m.reshape(b, -1) > 0).any(1)[:, None].float()
        return {
            "low_res_multimasks": low_res_masks,
            "ious": torch.ones((b, 1), device=m.device),
            "low_res_masks": low_res_masks,
            "high_res_masks": high_res_masks,
            "obj_ptr": lam * heads["obj_ptr"] + (1 - lam) * self.no_obj_ptr,
            "object_score_logits": 20.0 * lam - 10.0,
        }

    # ------------------------------------------------------------------

    def encode_memory(self, vision_tokens, high_res_masks, object_score_logits,
                      is_mask_from_pts: bool = False):
        """vision_tokens (B, HW, C) un-conditioned; high_res_masks (B, 1,
        Himg, Wimg) logits; object_score_logits (B, 1) -> (B, Hm, Wm,
        mem_dim) fp32."""
        b = vision_tokens.shape[0]
        fs = self.feat_size
        pix_feat = vision_tokens.reshape(b, fs, fs, self.d_model)
        masks = high_res_masks.permute(0, 2, 3, 1)
        mask_for_mem = (masks > 0).float() if is_mask_from_pts else torch.sigmoid(masks)
        mask_for_mem = mask_for_mem * self.sigmoid_scale_for_mem_enc + self.sigmoid_bias_for_mem_enc
        mem, _ = self.memory_encoder(pix_feat, mask_for_mem, skip_mask_sigmoid=True)
        is_obj = (object_score_logits > 0).to(mem.dtype)
        return mem + (1.0 - is_obj[:, :, None, None]) * self.no_obj_embed_spatial[0]


def flatten_kv_bank(k_entries, v_entries):
    """Stack per-entry caches into the flat, padded persistent bank.

    k_entries: n_mem entries of (L, B, S_e, C) from encode_memory_kv;
    v_entries: n_mem entries of (B, S_e, mem_dim). Returns (k_bank (L, B,
    S_pad, C), v_bank (B, S_pad, mem_dim)), S_pad = padded_bank_len(n_mem *
    S_e); entry j occupies rows [j * S_e, (j + 1) * S_e) and the pad rows
    are zeros (masked by condition_features_cached)."""
    k = torch.cat(list(k_entries), dim=2)
    v = torch.cat(list(v_entries), dim=1)
    pad = padded_bank_len(k.shape[2]) - k.shape[2]
    return F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))


_TN_PARAMS = ("maskmem_tpos_enc", "no_mem_embed", "no_mem_pos_enc", "no_obj_ptr",
              "no_obj_embed_spatial")


def init_tracker_variables(core: TrackerCore, seed: int = 0) -> dict:
    """Seeded values for every parameter of ``core`` (``init_tracker_parameters``),
    returned as JAX's variables are: {"params": {name: tensor}}."""
    init_tracker_parameters(core, seed)
    return {"params": {k: p.detach() for k, p in core.named_parameters()}}


@torch.no_grad()
def init_tracker_parameters(core: TrackerCore, seed: int = 0) -> TrackerCore:
    """Seeded random values for every parameter of a TrackerCore (the
    counterpart of init_tracker_variables): normals of std 0.02 truncated at
    2 std for the raw embeddings, unit normals for the prompt encoder's
    Fourier matrix, 1e-6 for the CXBlock layer scales, zeros for biases,
    ones for the other vectors, fan-in scaled normals for matrices and
    kernels."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in core.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _TN_PARAMS:
            val = (0.02 * torch.randn(p.shape, generator=gen)).clamp(-0.04, 0.04)
        elif leaf == "positional_encoding_gaussian_matrix":
            val = torch.randn(p.shape, generator=gen)
        elif leaf == "gamma":
            val = torch.full(p.shape, 1e-6)
        elif leaf == "bias":
            val = torch.zeros(p.shape)
        elif p.ndim == 1:
            val = torch.ones(p.shape)
        else:
            val = torch.randn(p.shape, generator=gen) / math.sqrt(math.prod(p.shape[1:]))
        p.copy_(val)
    return core
