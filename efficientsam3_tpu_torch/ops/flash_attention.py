"""Flash attention kernels for the H100, with their plain versions.

``flash_sdpa`` replaces the Pallas ``flash_sdpa`` forward
(efficientsam3_tpu/ops/pallas/flash_attention.py ``_flash_fwd`` /
``_kernel`` and ``_flash_fwd_packed`` / ``_packed_kernel``) at head dims 32
(the fusion encoder), 64 (the SAM3 teacher's ViTDet global blocks and the
vit_b / vit_l SAM1 students'), 80 (the vit_h SAM1 student's) and 256 (the
tracker's memory attention), and at the same four its custom VJP
(``_flash_bwd``: ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) through
``flash_sdpa_bwd_dq`` / ``flash_sdpa_bwd_dkv``;
``flash_memattn`` replaces ``flash_memattn`` / ``_memattn_kernel`` and
``_memattn_kernel_lse`` (the tracker's cached memory bank, raw dv = 64
values); ``flash_memattn_q8`` replaces ``flash_memattn_q8`` /
``_memattn_kernel_q8`` and ``_memattn_kernel_q8_lse`` (the same bank with
int8 keys, the score product on the int8 tensor cores; ``quantize_rows``
makes the int8 rows); ``flash_xattn_rpb`` replaces ``flash_xattn_rpb`` /
``_xattn_rpb_kernel``. The kernels are CUDA C++ in ``csrc/`` (see the notes
at the top of each source for what bounds them on the H100 and how the
design answers it), built by ``ops/_build.py`` on first use and called
through ctypes on PyTorch's current stream.

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors, raising on what the kernel does not take
(``kernel_dtype``: float operands other than bf16 or fp32, or of mixed
dtypes; head dims it was not built for; ``models/common.flash_eligible``
sends such attentions to the matmul path before they get here). Every
kernel has a bf16 and an fp32 instantiation, the fp32 one on split bf16
parts (csrc/wgmma_common.cuh); outputs come back in
the operands' dtype, the log-sum-exp in fp32. Each counts its kernel
launches in ``<wrapper>.launches``; the ``flash_sdpa`` forward is the wgmma
kernel ``csrc/flash_sdpa_h.cu`` in bf16 and ``csrc/flash_sdpa_h_fp32.cu`` in
fp32 (split bf16 parts) at d=32, 64, 80 and 256 (``sdpa_kernel`` says which
kernel a call reaches), ``flash_memattn`` the wgmma kernel
``csrc/flash_memattn_h.cu`` in both dtypes (``memattn_kernel``), and
``flash_memattn_q8`` its int8-key instantiations (``memattn_q8_kernel``),
``flash_xattn_rpb`` the wgmma kernel ``csrc/flash_xattn_rpb.cu`` (one
launch, its key splits merged inside a thread-block cluster);
``flash_sdpa_bwd_dkv`` at d=32, 64 and 80 is the wgmma kernel
``csrc/flash_sdpa_bwd_h.cu`` in bf16 and ``csrc/flash_sdpa_bwd_h_fp32.cu`` in
fp32 (split bf16 parts), ``flash_sdpa_bwd_dq`` at d=32, 64 and 80
``csrc/flash_sdpa_bwd_dq_h.cu`` in bf16 and ``csrc/flash_sdpa_bwd_dq_h_fp32.cu``
in fp32 (``bwd_dkv_kernel``, ``bwd_dq_kernel``), and both backward kernels
at d=256 those of ``csrc/flash_sdpa_bwd_wide_h.cu``
in bf16 and ``csrc/flash_sdpa_bwd_wide_h_fp32.cu`` in fp32 (the fp32 wgmma
kernels read split bf16 copies of their streamed operands, made by
``split_parts``; so do the fp32 forwards and ``flash_xattn_rpb``). Under
autograd (grad mode on and an input requiring a gradient) ``flash_sdpa`` runs as an
autograd Function whose backward is the two backward kernels; the
forward-only ``flash_memattn``, ``flash_memattn_q8`` and
``flash_xattn_rpb`` raise there rather than return a tensor cut from the
graph. On the CPU the plain versions are differentiated by autograd.

Layouts follow the JAX package: (B, H, N, D) heads. The kernels take any
strides over (B, H, N) with D contiguous, so ``split_heads`` views go in
without a copy, and they write the output (and the gradients) in
(B, N, H, D) memory order so that ``merge_heads`` is a view.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from efficientsam3_tpu_torch.ops import _build

NEG_INF = -1e9
_SUPPORTED_D = (32, 64, 80, 256)
# head dims of the backward kernels: the fusion encoder (32), the ViTDet
# trunks' global blocks in Stage-1 training (64, 80), memory attention (256)
_BWD_D = (32, 64, 80, 256)
_MEMATTN_DIMS = ((256, 64),)  # (dk, dv) of flash_memattn's kernel
_XATTN_TILE = 64  # query and key tile of flash_xattn_rpb (csrc/flash_xattn_rpb.cu BM, BN)
_XATTN_MAX_CLUSTER = 8  # its key splits, one cluster: the portable cluster size

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


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def kernel_dtype(name, *ts):
    """The dtype a kernel call runs in: that of its float operands, which
    must all be bfloat16 or all float32; anything else raises TypeError."""
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1 or ts[0].dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes bfloat16 or float32 operands, all of one dtype, "
                        f"got {[str(t.dtype) for t in ts]}")
    return ts[0].dtype


def _check_heads(name, dims, *ts):
    dtype = kernel_dtype(name, *ts)
    for t in ts:
        if t.shape[-1] not in dims:
            raise ValueError(f"{name} kernel supports head dims {dims}, got {t.shape[-1]}")
    return dtype


# head dims of the bf16 wgmma dkv kernel (csrc/flash_sdpa_bwd_h.cu)
_H_D = (32, 64, 80)
# head dims of the wgmma forward kernels: bf16 (csrc/flash_sdpa_h.cu) and
# fp32 on split bf16 parts (csrc/flash_sdpa_h_fp32.cu)
_FWD_H_D = (32, 64, 80, 256)


def sdpa_kernel(dtype, d):
    """The forward kernel a CUDA ``flash_sdpa`` call launches (d=32, 64, 80
    and 256): the wgmma kernels, csrc/flash_sdpa_h.cu for bf16 and
    csrc/flash_sdpa_h_fp32.cu for fp32 (split bf16 parts read from
    ``split_parts`` copies of K and V)."""
    return "flash_sdpa_h" if dtype == torch.bfloat16 else "flash_sdpa_h_fp32"


def memattn_kernel(dtype):
    """The kernel a CUDA ``flash_memattn`` call launches: the wgmma kernel
    of csrc/flash_memattn_h.cu in bf16, or in fp32 on split bf16 parts
    (``split_parts`` copies of K and V first)."""
    return "flash_memattn_h" if dtype == torch.bfloat16 else "flash_memattn_h_fp32"


def memattn_q8_kernel(dtype):
    """The kernel a CUDA ``flash_memattn_q8`` call launches: the int8-key
    instantiation of csrc/flash_memattn_h.cu (wgmma's int8 product for Q
    K^T), with bf16 q and v, or fp32 ones (P V on split bf16 parts of v: a
    ``split_parts`` copy first)."""
    return "flash_memattn_q8_h" if dtype == torch.bfloat16 else "flash_memattn_q8_h_fp32"


def _bwd_wide_kernel(dtype):
    """The d=256 backward kernels' source: csrc/flash_sdpa_bwd_wide_h.cu for
    bf16, csrc/flash_sdpa_bwd_wide_h_fp32.cu (split bf16 parts) for fp32."""
    return "flash_sdpa_bwd_wide_h" if dtype == torch.bfloat16 else "flash_sdpa_bwd_wide_h_fp32"


# head dims of the bf16 wgmma dq kernel (csrc/flash_sdpa_bwd_dq_h.cu) and of
# the fp32 wgmma dq and dkv kernels (csrc/flash_sdpa_bwd_dq_h_fp32.cu,
# csrc/flash_sdpa_bwd_h_fp32.cu)
_DQ_H_D = (32, 64, 80)
_DQ_H_F32_D = (32, 64, 80)
_DKV_H_F32_D = (32, 64, 80)


def bwd_dq_kernel(dtype, d):
    """The dq kernel a CUDA ``flash_sdpa_bwd_dq`` call launches, a wgmma
    kernel at every head dim the backward takes: at d=256
    csrc/flash_sdpa_bwd_wide_h.cu for bf16 and
    csrc/flash_sdpa_bwd_wide_h_fp32.cu for fp32, at d=32, 64 and 80
    csrc/flash_sdpa_bwd_dq_h.cu for bf16 and csrc/flash_sdpa_bwd_dq_h_fp32.cu
    (split bf16 parts) for fp32."""
    if d == 256:
        return _bwd_wide_kernel(dtype)
    return "flash_sdpa_bwd_dq_h" if dtype == torch.bfloat16 else "flash_sdpa_bwd_dq_h_fp32"


def bwd_dkv_kernel(dtype, d):
    """The dkv kernel a CUDA ``flash_sdpa_bwd_dkv`` call launches, a wgmma
    kernel at every head dim the backward takes: at d=256 as
    ``bwd_dq_kernel``, at d=32, 64 and 80 csrc/flash_sdpa_bwd_h.cu for bf16
    and csrc/flash_sdpa_bwd_h_fp32.cu (split bf16 parts) for fp32."""
    if d == 256:
        return _bwd_wide_kernel(dtype)
    return "flash_sdpa_bwd_h" if dtype == torch.bfloat16 else "flash_sdpa_bwd_h_fp32"


def _aligned(t):
    """D contiguous and 16-byte aligned rows (the kernels load 16 bytes)."""
    ok = (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all((s * t.element_size()) % 16 == 0 for s in t.stride()[:-1])
    )
    return t if ok else t.contiguous()


def _bhn_strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _bind(source, name, argtypes):
    """The C entry point ``name`` of ``csrc/<source>.cu``, its argument
    types set on first use (each accessor below names one entry point;
    tests/test_torch_csrc_signatures.py holds them against the sources)."""
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return fn


def _lib_sdpa_h():
    return _bind("flash_sdpa_h", "flash_sdpa_h_fwd",
                 [_P] * 6 + [_I] * 6 + [_F] + [_LL] * 12 + [_P])


def _lib_sdpa_h_attrs():
    return _bind("flash_sdpa_h", "flash_sdpa_h_attrs", [_I, _I, _P])


def _lib_sdpa_h_f32():
    """``flash_sdpa_h_f32_fwd`` of csrc/flash_sdpa_h_fp32.cu: q and the split
    copies of k and v, key bias, o, lse; 6 ints, the scale, q's and o's
    (B, H, N) strides, the stream."""
    return _bind("flash_sdpa_h_fp32", "flash_sdpa_h_f32_fwd",
                 [_P] * 6 + [_I] * 6 + [_F] + [_LL] * 6 + [_P])


def _lib_sdpa_h_f32_attrs():
    return _bind("flash_sdpa_h_fp32", "flash_sdpa_h_f32_attrs", [_I, _I, _P])


def _lib_bwd_h():
    return _bind("flash_sdpa_bwd_h", "flash_sdpa_bwd_dkv_h",
                 [_P] * 9 + [_I] * 6 + [_F] + [_LL] * 18 + [_P])


def _lib_bwd_h_attrs():
    return _bind("flash_sdpa_bwd_h", "flash_sdpa_bwd_dkv_h_attrs", [_I, _P])


def _lib_bwd_dq_h():
    return _bind("flash_sdpa_bwd_dq_h", "flash_sdpa_bwd_dq_h",
                 [_P] * 9 + [_I] * 6 + [_F] + [_LL] * 18 + [_P])


def _lib_bwd_dq_h_attrs():
    return _bind("flash_sdpa_bwd_dq_h", "flash_sdpa_bwd_dq_h_attrs", [_I, _I, _P])


def _lib_bwd_h_f32():
    """``flash_sdpa_bwd_dkv_h_f32`` of csrc/flash_sdpa_bwd_h_fp32.cu (the
    argument kinds of ``flash_sdpa_bwd_dkv_wide_f32`` and the head dim)."""
    return _bind("flash_sdpa_bwd_h_fp32", "flash_sdpa_bwd_dkv_h_f32",
                 [_P] * 9 + [_I] * 6 + [_F] + [_LL] * 12 + [_P])


def _lib_bwd_h_f32_attrs():
    return _bind("flash_sdpa_bwd_h_fp32", "flash_sdpa_bwd_dkv_h_f32_attrs", [_I, _P])


def _lib_bwd_dq_h_f32():
    """``flash_sdpa_bwd_dq_h_f32`` of csrc/flash_sdpa_bwd_dq_h_fp32.cu (the
    argument kinds of ``flash_sdpa_bwd_dq_wide_f32`` and the head dim)."""
    return _bind("flash_sdpa_bwd_dq_h_fp32", "flash_sdpa_bwd_dq_h_f32",
                 [_P] * 9 + [_I] * 6 + [_F] + [_LL] * 12 + [_P])


def _lib_bwd_dq_h_f32_attrs():
    return _bind("flash_sdpa_bwd_dq_h_fp32", "flash_sdpa_bwd_dq_h_f32_attrs", [_I, _I, _P])


def _lib_bwd_wide_h(name):
    """``flash_sdpa_bwd_dq_wide_h`` or ``flash_sdpa_bwd_dkv_wide_h`` of
    csrc/flash_sdpa_bwd_wide_h.cu (the same argument kinds as
    ``flash_sdpa_bwd_dkv_h``)."""
    return _bind("flash_sdpa_bwd_wide_h", name, [_P] * 9 + [_I] * 5 + [_F] + [_LL] * 18 + [_P])


def _lib_bwd_wide_h_dq_attrs():
    return _bind("flash_sdpa_bwd_wide_h", "flash_sdpa_bwd_dq_wide_h_attrs", [_I, _P])


def _lib_bwd_wide_h_dkv_attrs():
    return _bind("flash_sdpa_bwd_wide_h", "flash_sdpa_bwd_dkv_wide_h_attrs", [_P])


def _lib_bwd_wide_f32(name):
    """``flash_sdpa_bwd_dq_wide_f32`` or ``flash_sdpa_bwd_dkv_wide_f32`` of
    csrc/flash_sdpa_bwd_wide_h_fp32.cu: 9 pointers, 5 ints, the scale, 12
    strides (four operands' (B, H, N)), the stream."""
    return _bind("flash_sdpa_bwd_wide_h_fp32", name, [_P] * 9 + [_I] * 5 + [_F] + [_LL] * 12 + [_P])


def _lib_split_parts():
    return _bind("flash_sdpa_bwd_wide_h_fp32", "flash_sdpa_split_parts",
                 [_P] * 3 + [_I] * 6 + [_LL] * 3 + [_P])


def _lib_bwd_wide_f32_dq_attrs():
    return _bind("flash_sdpa_bwd_wide_h_fp32", "flash_sdpa_bwd_dq_wide_f32_attrs", [_I, _P])


def _lib_bwd_wide_f32_dkv_attrs():
    return _bind("flash_sdpa_bwd_wide_h_fp32", "flash_sdpa_bwd_dkv_wide_f32_attrs", [_P])


# the head dims kernel_resources reads each kernel of several at: the wgmma
# forwards at _FWD_H_D, the bank kernels (exact and int8 keys) at dk=256,
# the wgmma dkv at _H_D, the wgmma bf16 dq at _DQ_H_D, the fp32 dq and dkv
# at _DQ_H_F32_D and _DKV_H_F32_D
_RESOURCE_DIMS = {"flash_sdpa_h": _FWD_H_D, "flash_sdpa_h_fp32": _FWD_H_D,
                  "flash_memattn_h": (256,), "flash_memattn_h_fp32": (256,),
                  "flash_memattn_q8_h": (256,), "flash_memattn_q8_h_fp32": (256,),
                  "flash_sdpa_bwd_h": _H_D, "flash_sdpa_bwd_dq_h": _DQ_H_D,
                  "flash_sdpa_bwd_h_fp32": _DKV_H_F32_D,
                  "flash_sdpa_bwd_dq_h_fp32": _DQ_H_F32_D}


def kernel_resources(kernel, d=32, lk=5184):
    """Registers and spilled bytes a thread, shared bytes a block and
    resident blocks an SM of a wgmma kernel on the current CUDA device, as
    the runtime reports them (cudaFuncGetAttributes, the occupancy API):
    ``"flash_sdpa_h"`` (bf16 forward, d=32, 64, 80 or 256, lk keys),
    ``"flash_sdpa_h_fp32"`` (fp32 forward, d=32, 64, 80 or 256, lk keys),
    ``"flash_memattn_h"`` / ``"flash_memattn_h_fp32"`` (the bank kernel in
    bf16 / fp32, d=256, lk keys), ``"flash_memattn_q8_h"`` /
    ``"flash_memattn_q8_h_fp32"`` (its int8-key instantiations),
    ``"flash_sdpa_bwd_h"`` (bf16 dkv, d=32, 64 or 80),
    ``"flash_sdpa_bwd_dq_h"`` (bf16 dq, d=32, 64 or 80, lk keys),
    ``"flash_sdpa_bwd_h_fp32"`` (fp32 dkv, d=32, 64 or 80),
    ``"flash_sdpa_bwd_dq_h_fp32"`` (fp32 dq, d=32, 64 or 80, lk keys),
    ``"flash_sdpa_bwd_dq_wide_h"`` (d=256, lk keys),
    ``"flash_sdpa_bwd_dkv_wide_h"`` (d=256), or their fp32 counterparts
    ``"flash_sdpa_bwd_dq_wide_f32"`` (lk keys) and
    ``"flash_sdpa_bwd_dkv_wide_f32"``. A kernel or head dim not built
    raises ValueError before any library is loaded (the mma.sync kernels
    that wgmma kernels replaced among them)."""
    dims = _RESOURCE_DIMS.get(kernel)
    if dims is not None and d not in dims:
        raise ValueError(f"{kernel} kernel supports head dims {dims}, got {d}")
    out = (ctypes.c_int * 4)()
    if kernel == "flash_sdpa_h":
        status = _lib_sdpa_h_attrs()(d, lk, out)
    elif kernel == "flash_sdpa_h_fp32":
        status = _lib_sdpa_h_f32_attrs()(d, lk, out)
    elif kernel in ("flash_memattn_h", "flash_memattn_h_fp32"):
        status = _lib_memattn_h_attrs()(int(kernel == "flash_memattn_h_fp32"), lk, out)
    elif kernel in ("flash_memattn_q8_h", "flash_memattn_q8_h_fp32"):
        status = _lib_memattn_q8_h_attrs()(int(kernel == "flash_memattn_q8_h_fp32"), lk, out)
    elif kernel == "flash_sdpa_bwd_h":
        status = _lib_bwd_h_attrs()(d, out)
    elif kernel == "flash_sdpa_bwd_dq_h":
        status = _lib_bwd_dq_h_attrs()(d, lk, out)
    elif kernel == "flash_sdpa_bwd_h_fp32":
        status = _lib_bwd_h_f32_attrs()(d, out)
    elif kernel == "flash_sdpa_bwd_dq_h_fp32":
        status = _lib_bwd_dq_h_f32_attrs()(d, lk, out)
    elif kernel == "flash_sdpa_bwd_dq_wide_h":
        status = _lib_bwd_wide_h_dq_attrs()(lk, out)
    elif kernel == "flash_sdpa_bwd_dkv_wide_h":
        status = _lib_bwd_wide_h_dkv_attrs()(out)
    elif kernel == "flash_sdpa_bwd_dq_wide_f32":
        status = _lib_bwd_wide_f32_dq_attrs()(lk, out)
    elif kernel == "flash_sdpa_bwd_dkv_wide_f32":
        status = _lib_bwd_wide_f32_dkv_attrs()(out)
    else:
        raise ValueError(f"no resource query for kernel {kernel!r}")
    _build.check(status, f"{kernel} attributes")
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), out))


def _tma_rows(rows, fill):
    """A (R, L) tensor of rows as the wgmma kernels' TMA reads them: f32,
    contiguous, 16-byte aligned, padded with ``fill`` to a multiple of 4
    columns (a copy only when it is not so already). Returns (rows, padded
    width)."""
    r, n = rows.shape
    x = rows.float().contiguous()
    width = -(-n // 4) * 4
    if width != n or x.data_ptr() % 16:
        padded = torch.full((r, width), fill, dtype=torch.float32, device=x.device)
        padded[:, :n] = x
        x = padded
    return x, width


def _lib_xattn():
    """``flash_xattn_rpb_fwd`` of csrc/flash_xattn_rpb.cu: q, k, v, ey, ex,
    o; 9 ints, the scale, q's, k's, v's and o's (B, H, N) strides, the
    stream."""
    return _bind("flash_xattn_rpb", "flash_xattn_rpb_fwd",
                 [_P] * 6 + [_I] * 9 + [_F] + [_LL] * 12 + [_P])


def _lib_xattn_attrs():
    return _bind("flash_xattn_rpb", "flash_xattn_rpb_attrs", [_I] * 4 + [_P])


def xattn_resources(dtype, feat_hw, splits):
    """The resources of ``flash_xattn_rpb``'s kernel (bf16 or fp32) for an
    h x w map in ``splits`` key splits, on the current device: registers and
    spilled bytes a thread, shared bytes a block, resident blocks an SM,
    clusters of ``splits`` blocks resident at once on the device, and the
    K / V stages a block holds."""
    out = (ctypes.c_int * 6)()
    status = _lib_xattn_attrs()(int(dtype == torch.float32), feat_hw[0], feat_hw[1], splits, out)
    _build.check(status, "flash_xattn_rpb attributes")
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm", "max_clusters",
                     "stages"), out))


def _flash_sdpa_fwd(q, k, v, key_bias, sm_scale, return_lse):
    """Launch the forward kernel (fp32 after two launches of the split pass,
    K's and V's: every row, at d=256 the rows of live 32-key tiles); (o, lse
    or None), o a (B, H, Lq, D) view of (B, Lq, H, D) memory."""
    dtype = _check_heads("flash_sdpa", _SUPPORTED_D, q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape or key_bias.shape != (b, lk):
        raise ValueError(f"flash_sdpa shapes: q {q.shape} k {k.shape} v {v.shape} "
                         f"key_bias {key_bias.shape}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if return_lse else None
    o_bhn = o.transpose(1, 2)
    strides = (*_bhn_strides(q), *_bhn_strides(k), *_bhn_strides(v), *_bhn_strides(o_bhn))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse_ptr = lse.data_ptr() if lse is not None else None
    with torch.cuda.device(q.device):  # the launch goes to the current device
        kb, lkb = _tma_rows(key_bias, NEG_INF)
        if dtype == torch.bfloat16:
            status = _lib_sdpa_h()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(), o.data_ptr(), lse_ptr,
                b, h, lq, lk, lkb, d, float(sm_scale), *strides, stream)
        else:
            tile = (kb, _WIDE_F32_TILE) if d == 256 else ()
            kp, vp = split_parts(k, *tile), split_parts(v, *tile)
            status = _lib_sdpa_h_f32()(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kb.data_ptr(), o.data_ptr(), lse_ptr,
                b, h, lq, lk, lkb, d, float(sm_scale), *_bhn_strides(q), *_bhn_strides(o_bhn),
                stream)
    _build.check(status, "flash_sdpa launch")
    flash_sdpa.launches += 1
    return o_bhn, lse


class _FlashSdpaFn(torch.autograd.Function):
    """flash_sdpa under autograd on CUDA: the forward kernel saves its
    log-sum-exp, the backward runs the dq and dkv kernels (the JAX custom
    VJP ``_fwd`` / ``_bwd``). key_bias gets a zero gradient, as there."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, sm_scale):
        o, lse = _flash_sdpa_fwd(q, k, v, key_bias, sm_scale, True)
        ctx.save_for_backward(q, k, v, key_bias, o, lse)
        ctx.sm_scale = sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, key_bias, o, lse = ctx.saved_tensors
        dq, delta = flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, ctx.sm_scale)
        dk, dv = flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, ctx.sm_scale)
        dbias = torch.zeros_like(key_bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None


def flash_sdpa(q, k, v, key_bias, sm_scale=None, return_lse=False):
    """Flash scaled-dot-product attention.

    q (B, H, Lq, D); k, v (B, H, Lk, D), bf16 or fp32; key_bias (B, Lk)
    additive f32 logits bias (-1e9 for masked keys). Returns (B, H, Lq, D)
    in q.dtype, and the (B, H, Lq) f32 log-sum-exp with return_lse. When autograd
    records the call (grad mode on, an input requiring a gradient) it runs
    as ``_FlashSdpaFn``, whose backward is the dq and dkv kernels (every
    head dim the forward takes); CPU tensors are differentiated through
    the plain version.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_sdpa_plain(q, k, v, key_bias, sm_scale, return_lse)
    if _build.needs_grad(q, k, v, key_bias):
        o, lse = _FlashSdpaFn.apply(q, k, v, key_bias, float(sm_scale))
    else:
        o, lse = _flash_sdpa_fwd(q, k, v, key_bias, sm_scale, return_lse)
    return (o, lse) if return_lse else o


flash_sdpa.launches = 0


# --------------------------------------------------------------------------
# flash_sdpa backward: the dq and dkv kernels' wrappers and plain versions
# --------------------------------------------------------------------------


def _bwd_p_ds(q, k, v, key_bias, lse, do, delta, sm_scale):
    """P rebuilt from the saved log-sum-exp (0 on rows whose lse is masked)
    and dS = P o (dO V^T - Delta), fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + key_bias.float()[:, None, None, :]
    valid = (lse > NEG_INF / 2)[..., None]
    p = torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, sm_scale):
    """The dq kernel's arithmetic: (dQ in q.dtype, Delta = rowsum(dO o O)
    fp32). dS is rounded to k's dtype before the product (a no-op at fp32),
    the scale applied at the end."""
    delta = (do.float() * o.float()).sum(-1)
    _, ds = _bwd_p_ds(q, k, v, key_bias, lse, do, delta, sm_scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * sm_scale
    return dq.to(q.dtype), delta


def flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, sm_scale):
    """The dkv kernel's arithmetic: dV = bf16(P)^T dO, dK = scale *
    bf16(dS)^T Q (P rounded to dO's dtype, dS to q's), in k's and v's
    dtypes."""
    p, ds = _bwd_p_ds(q, k, v, key_bias, lse, do, delta, sm_scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_sdpa_bwd_plain(q, k, v, key_bias, o, lse, do, sm_scale=None):
    """(dq, dk, dv) of flash_sdpa from its saved output and log-sum-exp:
    the arithmetic of the JAX ``_flash_bwd`` and of the two kernels."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dq, delta = flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, sm_scale)
    dk, dv = flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, sm_scale)
    return dq, dk, dv


def _check_bwd(q, k, v, key_bias, lse, *rest):
    dtype = _check_heads("flash_sdpa backward", _BWD_D, q, k, v, *rest)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if (k.shape != (b, h, lk, d) or v.shape != k.shape or key_bias.shape != (b, lk)
            or lse.shape != (b, h, lq) or any(t.shape != q.shape for t in rest)):
        raise ValueError(f"flash_sdpa backward shapes: q {q.shape} k {k.shape} v {v.shape} "
                         f"key_bias {key_bias.shape} lse {lse.shape}")
    return b, h, lq, lk, d


# key tile of the fp32 kernels that read split copies of K and V with dead
# tiles skipped: the d=256 dq kernel (csrc/flash_sdpa_bwd_wide_h_fp32.cu
# BS), the d=256 forward (csrc/flash_sdpa_h_fp32.cu wide::BN) and the bank
# kernel (csrc/flash_memattn_h.cu Cfg<2, false>::BN); the copies hold only
# the rows of live tiles of this many keys
_WIDE_F32_TILE = 32
# key tile of the int8 bank kernel (csrc/flash_memattn_h.cu Cfg<NP,
# true>::BN), whose fp32 form reads a split copy of v with dead tiles
# skipped
_Q8_TILE = 64


def split_parts_plain(x):
    """x as its split bf16 parts, stacked: (2, *x.shape) bf16, hi = bf16(x)
    rounded to nearest even, lo = bf16(x - hi) (x - hi is exact in fp32), so
    hi + lo carries 16 of fp32's 24 mantissa bits."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    return torch.stack((hi, (x - hi.float()).to(torch.bfloat16)))


# head dims of the split pass: the fp32 d=256 backward kernels' streamed
# operands, and at d=32, 64 and 80 the fp32 dkv kernel's Q and dO and the
# fp32 dq kernel's K and V
_SPLIT_D = (32, 64, 80, 256)


def check_split_parts(x, key_bias=None, tile=0):
    """What the split pass takes: x (B, H, N, d) float32 at d in _SPLIT_D;
    tile > 0 (skipping dead key tiles) at d=256 and d=64 only, with a (B,
    >= N) key_bias. Raises ValueError otherwise."""
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[-1] not in _SPLIT_D:
        raise ValueError(f"split_parts takes (B, H, N, d) float32 with d in {_SPLIT_D}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, _, n, d = x.shape
    if tile and d not in (64, 256):
        raise ValueError(f"split_parts skips dead key tiles (tile > 0) at d=256 and 64 only, "
                         f"got d={d}")
    if tile and (key_bias is None or key_bias.shape[0] != b or key_bias.shape[1] < n):
        raise ValueError("split_parts with tile > 0 needs a (B, >= N) key_bias")


def split_parts(x, key_bias=None, tile=0):
    """The split copy of x (B, H, N, d) fp32, d=256, 32, 64 or 80, that the
    fp32 wgmma kernels read through TMA (the forwards' and the dq kernels'
    K and V, the dkv kernels' Q and dO, the bank kernel's keys at d=256 and
    values at d=64): (2, B, H, N, d) bf16, ``split_parts_plain``. One
    launch of the split pass of csrc/flash_sdpa_bwd_wide_h_fp32.cu on CUDA
    (``check_split_parts`` says what it takes), counted in
    ``split_parts.launches``; the plain version for CPU tensors. With tile >
    0 (d=256 and 64) the kernel writes only the rows of the tiles of
    ``tile`` rows that hold a live key (key_bias (B, >= N) f32 > -5e8; keys
    past N ignored): the rest is left as allocated, and the kernel whose
    key tiles these are never reads it."""
    if not x.is_cuda:
        return split_parts_plain(x)
    check_split_parts(x, key_bias, tile)
    b, h, n, d = x.shape
    x = _aligned(x)
    kb = key_bias.float().contiguous() if tile else None
    parts = torch.empty((2, b, h, n, d), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib_split_parts()(
            x.data_ptr(), kb.data_ptr() if tile else None, parts.data_ptr(), b, h, n, d,
            kb.shape[1] if tile else 0, tile, *_bhn_strides(x),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "split_parts launch")
    split_parts.launches += 1
    return parts


split_parts.launches = 0


def flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, sm_scale):
    """dQ of flash_sdpa and Delta = rowsum(dO o O): (dq (B, H, Lq, D) in
    q.dtype, delta (B, H, Lq) f32). One kernel launch on CUDA (head dim 32,
    64, 80 or 256, bf16 or fp32; ``bwd_dq_kernel`` says which wgmma
    kernel), counted in
    ``flash_sdpa_bwd_dq.launches``; fp32 first makes the split copies of K
    and V with two launches of the split pass (``split_parts``: every row,
    at d=256 only the rows of live 32-key tiles). The plain version for CPU
    tensors."""
    if not q.is_cuda:
        return flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, sm_scale)
    b, h, lq, lk, d = _check_bwd(q, k, v, key_bias, lse, o, do)
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    lse = lse.float().contiguous()
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (*_bhn_strides(q), *_bhn_strides(k), *_bhn_strides(v), *_bhn_strides(o),
               *_bhn_strides(do), *_bhn_strides(dq))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = bwd_dq_kernel(q.dtype, d)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        if kernel in ("flash_sdpa_bwd_wide_h_fp32", "flash_sdpa_bwd_dq_h_fp32"):
            kb, lkb = _tma_rows(key_bias, NEG_INF)
            wide = kernel == "flash_sdpa_bwd_wide_h_fp32"
            kp, vp = (split_parts(t, kb, _WIDE_F32_TILE) if wide else split_parts(t)
                      for t in (k, v))
            head = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kb.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    b, h, lq, lk, lkb)
            tail = (float(sm_scale), *_bhn_strides(q), *_bhn_strides(o), *_bhn_strides(do),
                    *_bhn_strides(dq), stream)
            if wide:
                status = _lib_bwd_wide_f32("flash_sdpa_bwd_dq_wide_f32")(*head, *tail)
            else:  # the head dim is a template parameter there
                status = _lib_bwd_dq_h_f32()(*head, d, *tail)
        else:
            kb, lkb = _tma_rows(key_bias, NEG_INF)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
            if kernel == "flash_sdpa_bwd_dq_h":  # the head dim is a template parameter there
                status = _lib_bwd_dq_h()(*ptrs, b, h, lq, lk, lkb, d, float(sm_scale), *strides,
                                         stream)
            else:
                status = _lib_bwd_wide_h("flash_sdpa_bwd_dq_wide_h")(
                    *ptrs, b, h, lq, lk, lkb, float(sm_scale), *strides, stream)
    _build.check(status, "flash_sdpa_bwd_dq launch")
    flash_sdpa_bwd_dq.launches += 1
    return dq, delta


flash_sdpa_bwd_dq.launches = 0


def flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, sm_scale):
    """dK and dV of flash_sdpa, given Delta from ``flash_sdpa_bwd_dq``:
    (dk, dv) (B, H, Lk, D) in k's / v's dtype. One kernel launch on CUDA
    (``bwd_dkv_kernel`` says which), counted in
    ``flash_sdpa_bwd_dkv.launches``; fp32 (the split-bf16 wgmma kernels)
    first makes the split copies of Q and dO (every row) with two launches
    of the split pass (``split_parts``). The plain version for CPU
    tensors."""
    if not q.is_cuda:
        return flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, sm_scale)
    b, h, lq, lk, d = _check_bwd(q, k, v, key_bias, lse, do)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    key_bias = key_bias.float().contiguous()
    dk = torch.empty((b, lk, h, d), dtype=k.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((b, lk, h, d), dtype=v.dtype, device=q.device).transpose(1, 2)
    strides = (*_bhn_strides(q), *_bhn_strides(k), *_bhn_strides(v), *_bhn_strides(do),
               *_bhn_strides(dk), *_bhn_strides(dv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = bwd_dkv_kernel(q.dtype, d)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        lse, lqp = _tma_rows(lse.reshape(b * h, lq), NEG_INF)
        delta, _ = _tma_rows(delta.reshape(b * h, lq), 0.0)
        if kernel in ("flash_sdpa_bwd_wide_h_fp32", "flash_sdpa_bwd_h_fp32"):
            qp, dop = split_parts(q), split_parts(do)
            head = (qp.data_ptr(), dop.data_ptr(), k.data_ptr(), v.data_ptr(),
                    key_bias.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), b, h, lq, lk, lqp)
            tail = (float(sm_scale), *_bhn_strides(k), *_bhn_strides(v), *_bhn_strides(dk),
                    *_bhn_strides(dv), stream)
            if kernel == "flash_sdpa_bwd_h_fp32":  # the head dim is a template parameter there
                status = _lib_bwd_h_f32()(*head, d, *tail)
            else:
                status = _lib_bwd_wide_f32("flash_sdpa_bwd_dkv_wide_f32")(*head, *tail)
        else:
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
            if kernel == "flash_sdpa_bwd_h":  # the head dim is a template parameter there
                status = _lib_bwd_h()(*ptrs, b, h, lq, lk, lqp, d, float(sm_scale), *strides,
                                      stream)
            else:
                status = _lib_bwd_wide_h("flash_sdpa_bwd_dkv_wide_h")(
                    *ptrs, b, h, lq, lk, lqp, float(sm_scale), *strides, stream)
    _build.check(status, "flash_sdpa_bwd_dkv launch")
    flash_sdpa_bwd_dkv.launches += 1
    return dk, dv


flash_sdpa_bwd_dkv.launches = 0


def padded_bank_len(lk: int) -> int:
    """Key count rounded up so the JAX kernel's default key block tiles it
    exactly (2048 from 2048 keys on, else 128).

    The tracker's persistent memory bank is padded once to this length
    (``video/tracker.flatten_kv_bank``), so its layout matches the JAX
    package's; pad rows are zeros and masked (key_bias -1e9). The CUDA
    kernel skips the pad tail's 64-key tiles."""
    if lk >= 2048:
        return -(-lk // 2048) * 2048
    return -(-lk // 128) * 128


# The kernel's arithmetic does not depend on the value width: dv = 64 raw
# values go through the same fp32 max and sum and bf16 P as flash_sdpa.
flash_memattn_plain = flash_sdpa_plain


def check_bank_call(name, q, v, *others):
    """The dtype a bank kernel call (``flash_memattn``, ``flash_memattn_q8``)
    runs in: q, v and the other float operands all bf16 or all fp32
    (``kernel_dtype``), at a (dk, dv) pair the kernels were built for."""
    dtype = kernel_dtype(name, q, v, *others)
    if (q.shape[-1], v.shape[-1]) not in _MEMATTN_DIMS:
        raise ValueError(f"{name} kernel supports (dk, dv) in {_MEMATTN_DIMS}, "
                         f"got {(q.shape[-1], v.shape[-1])}")
    return dtype


def _lib_memattn_h():
    """``flash_memattn_h_fwd`` of csrc/flash_memattn_h.cu (bf16): q, k, v, key
    bias, o, lse; 5 ints, the scale, four operands' (B, H, N) strides, the
    stream."""
    return _bind("flash_memattn_h", "flash_memattn_h_fwd",
                 [_P] * 6 + [_I] * 5 + [_F] + [_LL] * 12 + [_P])


def _lib_memattn_h_f32():
    """``flash_memattn_h_f32_fwd``: q and the split copies of k and v, key
    bias, o, lse; 5 ints, the scale, q's and o's strides, the stream."""
    return _bind("flash_memattn_h", "flash_memattn_h_f32_fwd",
                 [_P] * 6 + [_I] * 5 + [_F] + [_LL] * 6 + [_P])


def _lib_memattn_h_attrs():
    return _bind("flash_memattn_h", "flash_memattn_h_attrs", [_I, _I, _P])


def flash_memattn(q, k, v, key_bias, sm_scale=None, return_lse=False):
    """Flash cross-attention whose values are narrower than its keys.

    q (B, H, Lq, Dk); k (B, H, Lk, Dk); v (B, H, Lk, Dv) raw (unprojected)
    values, all bf16 or all fp32; key_bias (B, Lk) f32 (-1e9 masks).
    Returns (B, H, Lq, Dv) in q.dtype, and the (B, H, Lq) f32 log-sum-exp
    with return_lse. A row
    whose keys are all masked gives 0 with lse -1e9 (the einsum path gives
    the uniform average; such rows are slot-gated by every caller). The
    denominator is summed in fp32 from the unrounded P, as the einsum path
    does (the TPU kernel summed the bf16-rounded P). On CUDA one launch of
    csrc/flash_memattn_h.cu (``memattn_kernel``), counted in
    ``flash_memattn.launches``; fp32 first makes the split copies of K and
    V (two launches of the split pass, the rows of live 32-key tiles).
    ``flash_memattn_q8`` is the same attention over int8 keys (the
    tracker's ``quantize_bank``).
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_memattn_plain(q, k, v, key_bias, sm_scale, return_lse)
    _build.refuse_grad("flash_memattn", q, k, v, key_bias)
    dtype = check_bank_call("flash_memattn", q, v, k)
    b, h, lq, dk = q.shape
    lk, dv = k.shape[2], v.shape[-1]
    if k.shape != (b, h, lk, dk) or v.shape != (b, h, lk, dv) or key_bias.shape != (b, lk):
        raise ValueError(f"flash_memattn shapes: q {q.shape} k {k.shape} v {v.shape} "
                         f"key_bias {key_bias.shape}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty((b, h, lq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if return_lse else None
    lse_ptr = lse.data_ptr() if lse is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):  # the launch goes to the current device
        kb, lkb = _tma_rows(key_bias, NEG_INF)
        if dtype == torch.bfloat16:
            status = _lib_memattn_h()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(), o.data_ptr(), lse_ptr,
                b, h, lq, lk, lkb, float(sm_scale), *_bhn_strides(q), *_bhn_strides(k),
                *_bhn_strides(v), *_bhn_strides(o), stream)
        else:
            kp, vp = (split_parts(t, kb, _WIDE_F32_TILE) for t in (k, v))
            status = _lib_memattn_h_f32()(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kb.data_ptr(), o.data_ptr(), lse_ptr,
                b, h, lq, lk, lkb, float(sm_scale), *_bhn_strides(q), *_bhn_strides(o), stream)
    _build.check(status, "flash_memattn launch")
    flash_memattn.launches += 1
    return (o, lse) if return_lse else o


flash_memattn.launches = 0


# --------------------------------------------------------------------------
# flash_memattn over an int8 key bank: csrc/flash_memattn_h.cu's int8-key
# instantiations
# --------------------------------------------------------------------------


def quantize_rows(x, scale_mul: float = 1.0, eps: float = 1e-8):
    """Symmetric per-row int8 quantization over the last axis.

    Returns (x_i8, scale) with x ~= x_i8 * scale; scale (..., 1) f32 is
    multiplied by scale_mul (the attention folds the softmax scale into the
    query scale). A zero row gets scale scale_mul * eps / 127 and zeros.
    Plain tensor ops, as in the JAX package: fp32 |max| floored at eps,
    / 127, round half to even, int8 cast. The division by 127 is a true
    division on every device (PyTorch's CUDA kernels multiply by the
    reciprocal of a Python scalar divisor, one bit off, which moves a few
    values across a rounding boundary against ``flash_memattn_q8``'s
    prologue and the JAX package)."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True).clamp_min(eps)
    s = amax / torch.full_like(amax, 127.0)
    return torch.round(xf / s).to(torch.int8), s * scale_mul


def flash_memattn_q8_plain(q, k_i8, k_scale, v, key_bias, sm_scale=None, return_lse=False):
    """The q8 kernel's arithmetic in plain PyTorch: q quantized per row with
    the softmax scale folded into its scale, the integer score product
    (exact in fp32: |s| <= 127 * 127 * Dk < 2^24 up to Dk = 1040), logits
    (s * k_scale) * q_scale with masked keys (key_bias <= -5e8) at -1e9,
    then the finalize of ``flash_memattn`` (fp32 max and sum, bf16 P for
    P V, a fully masked row 0 with lse -1e9)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qi, qs = quantize_rows(q, scale_mul=sm_scale)
    s = torch.matmul(qi.float(), k_i8.float().transpose(-1, -2))
    live = key_bias.float() > NEG_INF / 2  # (B, Lk)
    ks = torch.where(live, k_scale.float(), 0.0)[:, None, None, :]
    logits = s * ks * qs + torch.where(live, 0.0, NEG_INF)[:, None, None, :]
    row_valid = live.any(-1)[:, None, None].expand(logits.shape[:3])
    out, lse = _masked_softmax_pv(logits, v, row_valid)
    out = out.to(v.dtype)
    return (out, lse) if return_lse else out


def _lib_memattn_q8_h():
    """``flash_memattn_q8_h_fwd`` of csrc/flash_memattn_h.cu (bf16 q and v):
    q, the int8 keys, their scales, v, key bias, o, lse; 5 ints, the scale,
    four operands' (B, H, N) strides, the stream."""
    return _bind("flash_memattn_h", "flash_memattn_q8_h_fwd",
                 [_P] * 7 + [_I] * 5 + [_F] + [_LL] * 12 + [_P])


def _lib_memattn_q8_h_f32():
    """``flash_memattn_q8_h_f32_fwd`` (fp32 q and v): q, the int8 keys, their
    scales, the split copy of v, key bias, o, lse; 5 ints, the scale, q's,
    the keys' and o's strides, the stream."""
    return _bind("flash_memattn_h", "flash_memattn_q8_h_f32_fwd",
                 [_P] * 7 + [_I] * 5 + [_F] + [_LL] * 9 + [_P])


def _lib_memattn_q8_h_attrs():
    return _bind("flash_memattn_h", "flash_memattn_q8_h_attrs", [_I, _I, _P])


def flash_memattn_q8(q, k_i8, k_scale, v, key_bias, sm_scale=None, return_lse=False):
    """``flash_memattn`` over an int8-quantized key bank.

    q (B, H, Lq, Dk) float, quantized per query row inside the kernel (the
    values and scales of ``quantize_rows(q, sm_scale)``); k_i8 (B, H, Lk, Dk)
    int8 with k_scale (B, Lk) f32 from ``quantize_rows`` (the tracker
    quantizes the age-adjusted bank once per frame and layer); v (B, H, Lk,
    Dv) raw values; key_bias (B, Lk) f32, a 0 / -1e9 key mask. Lk must be
    padded (``padded_bank_len``), pad rows masked. Returns (B, H, Lq, Dv)
    in v.dtype, and the (B, H, Lq) f32 log-sum-exp with return_lse.

    On CUDA one launch of the int8-key instantiation of
    csrc/flash_memattn_h.cu (``memattn_q8_kernel``), counted in
    ``flash_memattn_q8.launches``: the score product as int8 x int8 ->
    int32 by wgmma, at (Dk, Dv) = (256, 64) with q, v and output all bf16
    or all fp32 (fp32 v on split bf16 parts: one launch of the split pass
    first, the rows of live 64-key tiles); other dims and dtypes raise, and
    so does a call that autograd records (forward only).
    CPU tensors take the plain version. Logits carry the symmetric int8
    error of both operands; the exact bank stays the default.
    """
    b, h, lq, dk = q.shape
    lk, dv = k_i8.shape[2], v.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dk)
    if lk != padded_bank_len(lk):
        raise ValueError(f"flash_memattn_q8 requires a pre-padded key bank (padded_bank_len): "
                         f"{lk} keys, padded {padded_bank_len(lk)}")
    if (k_i8.dtype != torch.int8 or k_i8.shape != (b, h, lk, dk) or v.shape != (b, h, lk, dv)
            or k_scale.shape != (b, lk) or key_bias.shape != (b, lk)):
        raise ValueError(f"flash_memattn_q8 shapes: q {q.shape} k_i8 {k_i8.shape} {k_i8.dtype} "
                         f"k_scale {k_scale.shape} v {v.shape} key_bias {key_bias.shape}")
    if not q.is_cuda:
        return flash_memattn_q8_plain(q, k_i8, k_scale, v, key_bias, sm_scale, return_lse)
    _build.refuse_grad("flash_memattn_q8", q, k_scale, v, key_bias)
    dtype = check_bank_call("flash_memattn_q8", q, v)
    q, k_i8, v = _aligned(q), _aligned(k_i8), _aligned(v)
    o = torch.empty((b, h, lq, dv), dtype=v.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if return_lse else None
    lse_ptr = lse.data_ptr() if lse is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):  # the launch goes to the current device
        kb, lkb = _tma_rows(key_bias, NEG_INF)
        ks, _ = _tma_rows(k_scale, 0.0)
        head = (q.data_ptr(), k_i8.data_ptr(), ks.data_ptr())
        if dtype == torch.bfloat16:
            status = _lib_memattn_q8_h()(
                *head, v.data_ptr(), kb.data_ptr(), o.data_ptr(), lse_ptr, b, h, lq, lk, lkb,
                float(sm_scale), *_bhn_strides(q), *_bhn_strides(k_i8), *_bhn_strides(v),
                *_bhn_strides(o), stream)
        else:
            vp = split_parts(v, kb, _Q8_TILE)
            status = _lib_memattn_q8_h_f32()(
                *head, vp.data_ptr(), kb.data_ptr(), o.data_ptr(), lse_ptr, b, h, lq, lk, lkb,
                float(sm_scale), *_bhn_strides(q), *_bhn_strides(k_i8), *_bhn_strides(o), stream)
    _build.check(status, "flash_memattn_q8 launch")
    flash_memattn_q8.launches += 1
    return (o, lse) if return_lse else o


flash_memattn_q8.launches = 0


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


def xattn_cluster(batch_heads: int, lq: int, lk: int, slots: int, resident=None) -> int:
    """The key splits of ``flash_xattn_rpb``, which are its cluster size:
    the most, up to 8 (the portable cluster size) and the key tiles, that
    keep the grid (splits x query tiles x batch_heads blocks) one wave:
    within ``slots`` blocks (SMs x blocks an SM) and, with ``resident``
    (splits -> clusters of that size the card holds at once), every cluster
    resident. At least 1."""
    clusters = -(-lq // _XATTN_TILE) * batch_heads
    for splits in range(min(_XATTN_MAX_CLUSTER, -(-lk // _XATTN_TILE)), 1, -1):
        if splits * clusters <= slots and (resident is None or clusters <= resident(splits)):
            return splits
    return 1


@functools.lru_cache(maxsize=None)
def _xattn_occupancy(device_index, fp32, feat_hw, splits):
    """(blocks an SM, clusters of ``splits`` resident at once) of the kernel
    on a device, for an h x w map."""
    with torch.cuda.device(device_index):
        res = xattn_resources(torch.float32 if fp32 else torch.bfloat16, feat_hw, splits)
    return res["blocks_per_sm"], res["max_clusters"]


def xattn_splits_for(dtype, batch_heads, lq, feat_hw, device_index=0):
    """The key splits ``flash_xattn_rpb`` takes on a CUDA device:
    ``xattn_cluster`` on its SMs and the kernel's occupancy there."""
    fp32 = dtype == torch.float32

    def resident(splits):
        return _xattn_occupancy(device_index, fp32, tuple(feat_hw), splits)[1]
    slots = _num_sms(device_index) * _xattn_occupancy(device_index, fp32, tuple(feat_hw), 1)[0]
    return xattn_cluster(batch_heads, lq, feat_hw[0] * feat_hw[1], slots, resident)


def xattn_split_tiles(k_tiles: int, splits: int):
    """The key tiles [start, stop) of each split, as the kernel takes them:
    split s has [s k_tiles // splits, (s + 1) k_tiles // splits)."""
    return [(s * k_tiles // splits, (s + 1) * k_tiles // splits) for s in range(splits)]


def flash_xattn_rpb(q, k, v, ey, ex, feat_hw, sm_scale=None, splits=None):
    """Flash cross-attention with the decoder's boxRPB bias decomposed.

    q (B, H, NQ, D); k, v (B, H, L, D) with L == h*w (row-major image
    tokens), all bf16 or all fp32; ey (B, H, NQ, h), ex (B, H, NQ, w) f32
    with bias[b, n, q, y*w+x] = ey[b, n, q, y] + ex[b, n, q, x]. Returns
    (B, H, NQ, D) in q.dtype. Forward only. On CUDA one kernel launch (fp32
    after the two split passes of k and v); ``splits`` (1 to 8, at most the
    64-key tiles) overrides ``xattn_cluster``'s key splits.
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
    _build.refuse_grad("flash_xattn_rpb", q, k, v, ey, ex)
    fp32 = int(_check_heads("flash_xattn_rpb", (32,), q, k, v) == torch.float32)
    if h_img >= 128 or w_img >= 128:
        raise ValueError(f"flash_xattn_rpb kernel takes maps under 128x128, got {feat_hw}")
    if ey.shape != (b, hn, lq, h_img) or ex.shape != (b, hn, lq, w_img):
        raise ValueError(f"flash_xattn_rpb: ey {ey.shape} ex {ex.shape}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    ey = ey.float().contiguous()
    ex = ex.float().contiguous()
    k_tiles = -(-lk // _XATTN_TILE)
    if splits is None:
        splits = xattn_splits_for(q.dtype, b * hn, lq, (h_img, w_img), q.device.index)
    elif not 1 <= splits <= min(_XATTN_MAX_CLUSTER, k_tiles):
        raise ValueError(f"flash_xattn_rpb: {splits} splits for {k_tiles} key tiles "
                         f"(1 to {_XATTN_MAX_CLUSTER})")
    o = torch.empty((b, lq, hn, d), dtype=q.dtype, device=q.device)
    o_bhn = o.transpose(1, 2)
    fn = _lib_xattn()
    with torch.cuda.device(q.device):  # the launch goes to the current device
        if fp32:  # the kernel reads split bf16 copies of k and v
            k, v = split_parts(k), split_parts(v)
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ey.data_ptr(), ex.data_ptr(),
            o.data_ptr(), b, hn, lq, lk, d, fp32, h_img, w_img, splits, float(sm_scale),
            *_bhn_strides(q), *_bhn_strides(k[0] if fp32 else k),
            *_bhn_strides(v[0] if fp32 else v), *_bhn_strides(o_bhn),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "flash_xattn_rpb launch")
    flash_xattn_rpb.launches += 1
    return o_bhn


flash_xattn_rpb.launches = 0
