"""Flash attention forward kernels for the H100, with their plain versions.

``flash_sdpa`` replaces the Pallas ``flash_sdpa`` forward
(efficientsam3_tpu/ops/pallas/flash_attention.py ``_flash_fwd`` /
``_kernel`` and ``_flash_fwd_packed`` / ``_packed_kernel``);
``flash_xattn_rpb`` replaces ``flash_xattn_rpb`` / ``_xattn_rpb_kernel``.
Both kernels are CUDA C++ in ``csrc/`` (see the notes at the top of each
source for what bounds them on the H100 and how the design answers it),
built by ``ops/_build.py`` on first use and called through ctypes on
PyTorch's current stream.

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors, raising on what the kernel does not take
(dtype other than bf16, head dims other than 32). Each counts its kernel
launches in ``<wrapper>.launches``.

Layouts follow the JAX package: (B, H, N, D) heads. The kernels take any
strides over (B, H, N) with D contiguous, so ``split_heads`` views go in
without a copy, and they write the output in (B, N, H, D) memory order so
that ``merge_heads`` is a view.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from efficientsam3_tpu_torch.ops import _build

NEG_INF = -1e9
_SUPPORTED_D = (32,)
_BK = 64  # key tile of the CUDA kernels (attn_common.cuh BK)
_BQ = 64  # query tile (attn_common.cuh BQ)

_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p


def _masked_softmax_pv(logits, v, row_valid=None):
    """The kernels' finalize in plain PyTorch: fp32 max and sum, P cast to
    v.dtype for the PV product (fp32 accumulate), divide by max(l, 1e-30).
    Rows with row_valid False return 0 and lse -1e9 (every tile skipped)."""
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    out = pv / l.clamp_min(1e-30)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    if row_valid is not None:
        out = torch.where(row_valid[..., None], out, torch.zeros_like(out))
        lse = torch.where(row_valid, lse, torch.full_like(lse, NEG_INF))
    return out, lse


def flash_sdpa_plain(q, k, v, key_bias, sm_scale=None, return_lse=False):
    """softmax(q k^T * scale + key_bias) v, the kernel's arithmetic.

    q (B, H, Lq, D); k, v (B, H, Lk, D); key_bias (B, Lk) f32 (-1e9 masks).
    A batch row whose keys are all masked gives 0 (lse -1e9), as the
    kernel skips every one of its key tiles.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    key_bias = key_bias.float()
    logits = logits + key_bias[:, None, None, :]
    any_valid = (key_bias > NEG_INF / 2).any(-1)  # (B,)
    row_valid = any_valid[:, None, None].expand(logits.shape[:3])
    out, lse = _masked_softmax_pv(logits, v, row_valid)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def _check_heads(name, *ts):
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16 tensors, got {t.dtype}")
        if t.shape[-1] not in _SUPPORTED_D:
            raise ValueError(
                f"{name} kernel supports head dims {_SUPPORTED_D}, got {t.shape[-1]}"
            )


def _aligned(t):
    """D contiguous and 16-byte aligned rows (the kernels load 16 bytes)."""
    ok = (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all(s % 8 == 0 for s in t.stride()[:-1])
    )
    return t if ok else t.contiguous()


def _bhn_strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _lib_sdpa():
    lib = _build.load("flash_sdpa")
    fn = lib.flash_sdpa_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 5 + [_F] + [_LL] * 12 + [_P]
        fn.restype = _I
    return fn


def _lib_xattn():
    lib = _build.load("flash_xattn_rpb")
    fn = lib.flash_xattn_rpb_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 9 + [_F] + [_LL] * 12 + [_P]
        fn.restype = _I
    return fn


def flash_sdpa(q, k, v, key_bias, sm_scale=None, return_lse=False):
    """Flash scaled-dot-product attention forward.

    q (B, H, Lq, D); k, v (B, H, Lk, D); key_bias (B, Lk) additive f32
    logits bias (-1e9 for masked keys). Returns (B, H, Lq, D) in q.dtype,
    and the (B, H, Lq) f32 log-sum-exp with return_lse.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_sdpa_plain(q, k, v, key_bias, sm_scale, return_lse)
    _check_heads("flash_sdpa", q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape or key_bias.shape != (b, lk):
        raise ValueError(f"flash_sdpa shapes: q {q.shape} k {k.shape} v {v.shape} "
                         f"key_bias {key_bias.shape}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    key_bias = key_bias.float().contiguous()
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if return_lse else None
    o_bhn = o.transpose(1, 2)
    fn = _lib_sdpa()
    with torch.cuda.device(q.device):  # the launch goes to the current device
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
            o.data_ptr(), lse.data_ptr() if lse is not None else None,
            b, h, lq, lk, d, float(sm_scale),
            *_bhn_strides(q), *_bhn_strides(k), *_bhn_strides(v), *_bhn_strides(o_bhn),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "flash_sdpa launch")
    flash_sdpa.launches += 1
    return (o_bhn, lse) if return_lse else o_bhn


flash_sdpa.launches = 0


def rpb_bias(ey, ex, feat_hw):
    """The full (B, H, NQ, h*w) boxRPB bias: bias[.., q, y*w+x] = ey[.., q, y]
    + ex[.., q, x] in f32 (the einsum path's attn_mask)."""
    h_img, w_img = feat_hw
    full = ey.float()[..., :, None] + ex.float()[..., None, :]
    return full.reshape(*ey.shape[:3], h_img * w_img)


def flash_xattn_rpb_plain(q, k, v, ey, ex, feat_hw, sm_scale=None):
    """Cross-attention with the decomposed boxRPB bias, the kernel's
    arithmetic: exact f32 bias, fp32 softmax, P cast to v.dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    logits = logits + rpb_bias(ey, ex, feat_hw)
    out, _ = _masked_softmax_pv(logits, v)
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def xattn_splits(batch_heads: int, lq: int, lk: int, num_sms: int):
    """(splits, key tiles per split) so that about 2 blocks per SM run."""
    q_tiles = -(-lq // _BQ)
    k_tiles = -(-lk // _BK)
    want = max(1, min(k_tiles, -(-2 * num_sms // (q_tiles * batch_heads))))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per


def flash_xattn_rpb(q, k, v, ey, ex, feat_hw, sm_scale=None):
    """Flash cross-attention with the decoder's boxRPB bias decomposed.

    q (B, H, NQ, D); k, v (B, H, L, D) with L == h*w (row-major image
    tokens); ey (B, H, NQ, h), ex (B, H, NQ, w) f32 with
    bias[b, n, q, y*w+x] = ey[b, n, q, y] + ex[b, n, q, x]. Forward only.
    """
    h_img, w_img = feat_hw
    b, hn, lq, d = q.shape
    lk = k.shape[2]
    if lk != h_img * w_img:
        raise ValueError(f"flash_xattn_rpb: {lk} keys for a {feat_hw} map")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return flash_xattn_rpb_plain(q, k, v, ey, ex, feat_hw, sm_scale)
    _check_heads("flash_xattn_rpb", q, k, v)
    if h_img >= 128 or w_img >= 128:
        raise ValueError(f"flash_xattn_rpb kernel takes maps under 128x128, got {feat_hw}")
    if ey.shape != (b, hn, lq, h_img) or ex.shape != (b, hn, lq, w_img):
        raise ValueError(f"flash_xattn_rpb: ey {ey.shape} ex {ex.shape}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    ey = ey.float().contiguous()
    ex = ex.float().contiguous()
    nsplit, per = xattn_splits(b * hn, lq, lk, _num_sms(q.device.index))
    o = torch.empty((b, lq, hn, d), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((b * hn, nsplit, lq, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b * hn, nsplit, lq, 2), dtype=torch.float32, device=q.device)
    o_bhn = o.transpose(1, 2)
    fn = _lib_xattn()
    with torch.cuda.device(q.device):  # the launch goes to the current device
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ey.data_ptr(), ex.data_ptr(),
            o.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            b, hn, lq, lk, d, h_img, w_img, nsplit, per, float(sm_scale),
            *_bhn_strides(q), *_bhn_strides(k), *_bhn_strides(v), *_bhn_strides(o_bhn),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "flash_xattn_rpb launch")
    flash_xattn_rpb.launches += 1
    return o_bhn


flash_xattn_rpb.launches = 0
