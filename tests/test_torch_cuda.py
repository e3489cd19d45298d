"""The port's hand-written kernels against their plain PyTorch versions on
an NVIDIA GPU. Every test here needs the card and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX, skipping the repository's conftest (which imports it):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.ops import layer_norm as ln

NEG_INF = fa.NEG_INF
RNG = np.random.default_rng(13)
# bf16 outputs of kernel and plain version round the same fp32 values after
# sums in other orders: about one bf16 ulp, 2^-7 relative
TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.bfloat16):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(5184, 5184), (333, 517), (1, 64)])
def test_flash_sdpa_kernel_matches_plain(cuda, lq, lk):
    """Ragged Lq/Lk, a masked 64-key tile (skipped), a batch row with every
    key masked (0 out, lse -1e9), and the LSE output."""
    q, k, v = (_randn(cuda, 2, 8, n, 32) for n in (lq, lk, lk))
    bias = torch.zeros((2, lk), device=cuda)
    bias[0, 64:128] = NEG_INF
    bias[1] = NEG_INF
    before = fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_sdpa.launches == before + 1
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)
    assert (got[1] == 0).all() and (lse[1] == NEG_INF).all()


@pytest.mark.cuda
def test_flash_sdpa_kernel_reads_strided_heads(cuda):
    """split_heads views (heads interleaved in the token rows) go in without
    a copy, and the output comes back as a (B, N, H, D)-ordered view."""
    x = _randn(cuda, 1, 300, 8 * 32)
    q = x.reshape(1, 300, 8, 32).transpose(1, 2)
    bias = torch.zeros((1, 300), device=cuda)
    got = fa.flash_sdpa(q, q, q, bias)
    want = fa.flash_sdpa_plain(q, q, q, bias)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,hw", [(201, (72, 72)), (201, (18, 27)), (7, (3, 5))])
def test_flash_xattn_rpb_kernel_matches_plain(cuda, lq, hw):
    b, h = 2, 8
    lk = hw[0] * hw[1]
    q, k, v = (_randn(cuda, b, h, n, 32) for n in (lq, lk, lk))
    ey = _randn(cuda, b, h, lq, hw[0], dtype=torch.float32)
    ex = _randn(cuda, b, h, lq, hw[1], dtype=torch.float32)
    before = fa.flash_xattn_rpb.launches
    got = fa.flash_xattn_rpb(q, k, v, ey, ex, hw)
    torch.cuda.synchronize()
    assert fa.flash_xattn_rpb.launches == before + 1
    want = fa.flash_xattn_rpb_plain(q, k, v, ey, ex, hw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32),
])
@pytest.mark.parametrize("rows", [5184, 17])
def test_layer_norm_kernel_matches_plain(cuda, x_dtype, out_dtype, rows):
    x = 3.0 * _randn(cuda, rows, 256, dtype=x_dtype)
    w = 1.0 + 0.1 * _randn(cuda, 256, dtype=torch.float32)
    b = 0.1 * _randn(cuda, 256, dtype=torch.float32)
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, w, b, 1e-5, out_dtype)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == before + 1 and got.dtype == out_dtype
    want = ln.layer_norm_plain(x, w, b, 1e-5, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = _randn(cuda, 1, 2, 16, 32, dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_sdpa(q, q, q, torch.zeros((1, 16), device=cuda))
    q64 = _randn(cuda, 1, 2, 16, 64)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_sdpa(q64, q64, q64, torch.zeros((1, 16), device=cuda))
