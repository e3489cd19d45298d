"""Which dtype and head-dim pairs the port's CUDA kernels take, and which
kernel a call reaches, checked without a GPU: the wrappers' rule
(``kernel_dtype``, the head-dim and (dk, dv) checks, ``sdpa_kernel``,
``bwd_dq_kernel``, ``bwd_dkv_kernel``, depthwise's map check) applied to CPU tensors of each dtype and width.
Every kernel takes bf16 and fp32 operands of one dtype; fp16, fp64 and
mixed dtypes raise TypeError naming both, other widths ValueError.
"""

import pytest
import torch

import _torch_threads  # noqa: F401

from efficientsam3_tpu_torch.ops import depthwise as dw
from efficientsam3_tpu_torch.ops import flash_attention as fa

BF16, F32, F16, F64 = torch.bfloat16, torch.float32, torch.float16, torch.float64


def _t(d, dtype, n=4):
    return torch.zeros((1, 1, n, d), dtype=dtype)


def _sdpa(dtype, d, k_dtype=None):
    q = _t(d, dtype)
    dt = fa._check_heads("flash_sdpa", fa._SUPPORTED_D, q, _t(d, k_dtype or dtype), q)
    return fa.sdpa_kernel(dt, d)


def _bwd(dtype, d):
    """The source of the backward's first launch (dq) under autograd."""
    q = _t(d, dtype)
    dt = fa._check_heads("flash_sdpa backward", fa._BWD_D, q, q, q, q, q)
    return fa.bwd_dq_kernel(dt, d)


def _dq(dtype, d):
    q = _t(d, dtype)
    dt = fa._check_heads("flash_sdpa backward", fa._BWD_D, q, q, q, q, q)
    return fa.bwd_dq_kernel(dt, d)


def _dkv(dtype, d):
    q = _t(d, dtype)
    dt = fa._check_heads("flash_sdpa backward", fa._BWD_D, q, q, q, q)
    return fa.bwd_dkv_kernel(dt, d)


def _memattn(dtype, dk, dv=64, v_dtype=None):
    dt = fa.check_bank_call("flash_memattn", _t(dk, dtype), _t(dv, v_dtype or dtype),
                            _t(dk, dtype))
    return fa.memattn_kernel(dt)


def _q8(dtype, dk, dv=64):
    dt = fa.check_bank_call("flash_memattn_q8", _t(dk, dtype), _t(dv, dtype))
    return fa.memattn_q8_kernel(dt)


def _xattn(dtype, d):
    q = _t(d, dtype)
    fa._check_heads("flash_xattn_rpb", (32,), q, q, q)
    return "flash_xattn_rpb"


def _depthwise(dtype, ks=7):
    dw._check(torch.zeros((1, 4, 4, 8), dtype=dtype), torch.zeros((ks, ks, 1, 8)),
              torch.zeros(8))
    return "depthwise_conv2d"


CASES = [
    # flash_sdpa forward: the bf16 wgmma kernel at d=32, d=64 (the ViTDet
    # global blocks), d=80 (the vit_h student's) and d=256 (the tracker's
    # memory attention); the fp32 wgmma kernel (split bf16 parts) at the
    # same four
    (_sdpa, (BF16, 32), "flash_sdpa_h"),
    (_sdpa, (F32, 32), "flash_sdpa_h_fp32"),
    (_sdpa, (BF16, 256), "flash_sdpa_h"),
    (_sdpa, (F32, 256), "flash_sdpa_h_fp32"),
    (_sdpa, (F16, 32), TypeError),
    (_sdpa, (F64, 256), TypeError),
    (_sdpa, (BF16, 32, F32), TypeError),
    (_sdpa, (BF16, 64), "flash_sdpa_h"),
    (_sdpa, (F32, 64), "flash_sdpa_h_fp32"),
    (_sdpa, (BF16, 80), "flash_sdpa_h"),
    (_sdpa, (F32, 80), "flash_sdpa_h_fp32"),
    (_sdpa, (BF16, 48), ValueError),
    (_sdpa, (F32, 128), ValueError),
    # its backward kernels, all on wgmma: the bf16 dq and dkv kernels at
    # d=32, 64 and 80, the fp32 dq and dkv kernels at d=32, 64 and 80 (split
    # bf16 parts) and both kernels at d=256 (fp32 on split bf16 parts);
    # other widths raise
    (_bwd, (BF16, 32), "flash_sdpa_bwd_dq_h"),
    (_bwd, (F32, 32), "flash_sdpa_bwd_dq_h_fp32"),
    (_bwd, (F32, 256), "flash_sdpa_bwd_wide_h_fp32"),
    (_bwd, (F16, 256), TypeError),
    (_bwd, (F32, 64), "flash_sdpa_bwd_dq_h_fp32"),
    (_bwd, (F32, 80), "flash_sdpa_bwd_dq_h_fp32"),
    (_bwd, (BF16, 64), "flash_sdpa_bwd_dq_h"),
    (_bwd, (BF16, 80), "flash_sdpa_bwd_dq_h"),
    (_bwd, (BF16, 48), ValueError),
    (_dkv, (BF16, 32), "flash_sdpa_bwd_h"),
    (_dkv, (F32, 32), "flash_sdpa_bwd_h_fp32"),
    (_dkv, (BF16, 256), "flash_sdpa_bwd_wide_h"),
    (_dkv, (F32, 256), "flash_sdpa_bwd_wide_h_fp32"),
    (_dkv, (F16, 32), TypeError),
    (_dkv, (F16, 256), TypeError),
    (_dkv, (BF16, 64), "flash_sdpa_bwd_h"),
    (_dkv, (BF16, 80), "flash_sdpa_bwd_h"),
    (_dkv, (F32, 64), "flash_sdpa_bwd_h_fp32"),
    (_dkv, (F32, 80), "flash_sdpa_bwd_h_fp32"),
    (_dkv, (F32, 48), ValueError),
    (_dq, (BF16, 32), "flash_sdpa_bwd_dq_h"),
    (_dq, (F32, 32), "flash_sdpa_bwd_dq_h_fp32"),
    (_dq, (BF16, 256), "flash_sdpa_bwd_wide_h"),
    (_dq, (F32, 256), "flash_sdpa_bwd_wide_h_fp32"),
    (_dq, (F16, 256), TypeError),
    (_dq, (F64, 32), TypeError),
    (_dq, (BF16, 64), "flash_sdpa_bwd_dq_h"),
    (_dq, (BF16, 80), "flash_sdpa_bwd_dq_h"),
    (_dq, (F32, 64), "flash_sdpa_bwd_dq_h_fp32"),
    (_dq, (F32, 80), "flash_sdpa_bwd_dq_h_fp32"),
    (_dq, (F32, 48), ValueError),
    (_dq, (BF16, 48), ValueError),
    # the cached bank, exact and over int8 keys (the wgmma kernel of
    # flash_memattn_h.cu and its int8-key instantiation; fp32 on split bf16
    # parts)
    (_memattn, (BF16, 256), "flash_memattn_h"),
    (_memattn, (F32, 256), "flash_memattn_h_fp32"),
    (_memattn, (F16, 256), TypeError),
    (_memattn, (F32, 256, 64, BF16), TypeError),
    (_memattn, (F32, 128), ValueError),
    (_q8, (BF16, 256), "flash_memattn_q8_h"),
    (_q8, (F32, 256), "flash_memattn_q8_h_fp32"),
    (_q8, (F16, 256), TypeError),
    (_q8, (F32, 256, 32), ValueError),
    # the decoder's boxRPB cross-attention
    (_xattn, (BF16, 32), "flash_xattn_rpb"),
    (_xattn, (F32, 32), "flash_xattn_rpb"),
    (_xattn, (F64, 32), TypeError),
    (_xattn, (F32, 64), ValueError),
    # the memory encoder's 7x7 depthwise
    (_depthwise, (BF16,), "depthwise_conv2d"),
    (_depthwise, (F32,), "depthwise_conv2d"),
    (_depthwise, (F16,), TypeError),
    (_depthwise, (F32, 3), ValueError),
]


@pytest.mark.parametrize("check,args,expect", CASES,
                         ids=[f"{c.__name__[1:]}-{'-'.join(str(a).replace('torch.', '') for a in args)}"
                              for c, args, _ in CASES])
def test_kernel_dtype_and_width_rule(check, args, expect):
    if isinstance(expect, str):
        assert check(*args) == expect
    else:
        match = "bfloat16 or float32" if expect is TypeError else r"kernel (supports|takes a \()"
        with pytest.raises(expect, match=match):
            check(*args)


# The mma.sync kernels that the wgmma kernels replaced (the forward's
# register kernel in both dtypes at d=32, 64 and 80, its d=256 kernel in
# both dtypes and the bank kernel's mma.sync instantiations, the dkv kernel
# in both dtypes at d=32, 64 and 80, the dq kernel in both dtypes at d=32,
# 64 and 80, the int8 bank kernel) are not built: their resources cannot
# be asked for, and neither can a head dim a kernel lacks. Refused before
# any library is loaded (so here, without a GPU).
@pytest.mark.parametrize("kernel,d", [("flash_sdpa", 80), ("flash_sdpa_fp32", 32),
                                      ("flash_sdpa_fp32", 64), ("flash_sdpa_fp32", 80),
                                      ("flash_sdpa", 256), ("flash_sdpa_h_fp32", 128),
                                      ("flash_sdpa_h", 128), ("flash_sdpa_bwd_dkv", 64),
                                      ("flash_sdpa_bwd_dkv", 80), ("flash_sdpa_h", 48),
                                      ("flash_sdpa_bwd_h", 256), ("flash_sdpa_fp32", 256),
                                      ("flash_sdpa_bwd_dq", 64), ("flash_sdpa_bwd_dq", 80),
                                      ("flash_sdpa_bwd_dkv_fp32", 32),
                                      ("flash_sdpa_bwd_dkv_fp32", 64),
                                      ("flash_sdpa_bwd_dkv_fp32", 80),
                                      ("flash_sdpa_bwd_dq_fp32", 32),
                                      ("flash_sdpa_bwd_dq_fp32", 64),
                                      ("flash_sdpa_bwd_dq_fp32", 80),
                                      ("flash_sdpa_bwd_dq", 32), ("flash_sdpa_bwd_dq_h", 256),
                                      ("flash_sdpa_bwd_h_fp32", 256),
                                      ("flash_sdpa_bwd_dq_h_fp32", 48),
                                      ("flash_sdpa_bwd_dq_h_fp32", 256),
                                      ("flash_memattn", 256), ("flash_memattn_h", 64),
                                      ("flash_memattn_h_fp32", 128), ("flash_memattn_q8", 256),
                                      ("flash_memattn_q8_h", 128),
                                      ("flash_memattn_q8_h_fp32", 64)])
def test_replaced_instantiations_are_refused(kernel, d):
    with pytest.raises(ValueError, match=f"{kernel} kernel supports|no resource query"):
        fa.kernel_resources(kernel, d)
