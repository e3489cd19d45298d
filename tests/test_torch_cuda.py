"""The port's hand-written kernels against their plain PyTorch versions on
an NVIDIA GPU. Every test here needs the card and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX, skipping the repository's conftest (which imports it):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import ctypes

import numpy as np
import pytest
import torch

from efficientsam3_tpu_torch.ops import _build
from efficientsam3_tpu_torch.ops import depthwise as dw
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.ops import layer_norm as ln
from efficientsam3_tpu_torch.ops import rms_norm as rn

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
@pytest.mark.parametrize("lq,lk", [(5184, 5184), (333, 517), (70, 36352)])
def test_flash_sdpa_d256_kernel_matches_plain(cuda, lq, lk):
    """Head dim 256, one head (the tracker's memory attention): ragged
    Lq/Lk, a masked 64-key tile, a batch row with every key masked (an
    empty object slot: 0 out, lse -1e9), and the LSE output."""
    q, k, v = (_randn(cuda, 3, 1, n, 256) for n in (lq, lk, lk))
    bias = torch.zeros((3, lk), device=cuda)
    bias[0, 64:128] = NEG_INF
    bias[1] = NEG_INF
    bias[2, lk // 2:] = NEG_INF
    before = fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_sdpa.launches == before + 1
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)
    assert (got[1] == 0).all() and (lse[1] == NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(5184, 36864), (333, 517), (1, 64)])
def test_flash_memattn_kernel_matches_plain(cuda, lq, lk):
    """dk 256 against raw dv 64 values: ragged Lq/Lk, a masked bank entry
    and a masked pad tail, a fully masked row (0 out, lse -1e9), and the
    LSE; the values enter as a strided (B, 1, Lk, 64) view of a bank."""
    b = 3
    q = _randn(cuda, b, 1, lq, 256)
    k = _randn(cuda, b, 1, lk, 256)
    bank = _randn(cuda, b, lk, 64)
    v = bank[:, None]
    bias = torch.zeros((b, lk), device=cuda)
    bias[0, lk // 4: lk // 2] = NEG_INF
    bias[0, lk - lk // 8:] = NEG_INF
    bias[1] = NEG_INF
    before = fa.flash_memattn.launches
    got, lse = fa.flash_memattn(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_memattn.launches == before + 1 and got.shape == (b, 1, lq, 64)
    want, want_lse = fa.flash_memattn_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)
    assert (got[1] == 0).all() and (lse[1] == NEG_INF).all()
    torch.testing.assert_close(fa.flash_memattn(q, k, v, bias).float(), got.float(),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 72, 72, 256), (2, 13, 29, 40), (1, 9, 5, 37), (1, 3, 4, 1)])
def test_depthwise_kernel_matches_plain(cuda, shape):
    """The tracker shape, then odd H/W with C % 8 == 0, odd C (the element
    copy path) and a map smaller than the 7x7 kernel."""
    c = shape[-1]
    x = _randn(cuda, *shape)
    wk = 0.2 * _randn(cuda, 7, 7, 1, c, dtype=torch.float32)
    bias = 0.1 * _randn(cuda, c, dtype=torch.float32)
    before = dw.depthwise_conv2d.launches
    got = dw.depthwise_conv2d(x, wk, bias)
    torch.cuda.synchronize()
    assert dw.depthwise_conv2d.launches == before + 1 and got.dtype == torch.bfloat16
    want = dw.depthwise_conv2d_plain(x, wk, bias)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


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


# layer_norm's dtype pairs, and its channel counts: every model of the repo
# passes it 256 (the fusion encoder's and memory attention's norms, as
# chip_smoke.Capture records them), and 250, which the 16-byte vector
# divides in neither dtype (the masked path)
LN_DTYPES = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.float32), (torch.bfloat16, torch.float32)]
LN_CHANNELS = [256, 250]


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,out_dtype", LN_DTYPES)
@pytest.mark.parametrize("rows", [1, 17, 201, 5184, 20736])
@pytest.mark.parametrize("c", LN_CHANNELS)
def test_layer_norm_kernel_matches_plain(cuda, x_dtype, out_dtype, rows, c):
    x = 3.0 * _randn(cuda, rows, c, dtype=x_dtype)
    w = 1.0 + 0.1 * _randn(cuda, c, dtype=torch.float32)
    b = 0.1 * _randn(cuda, c, dtype=torch.float32)
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, w, b, 1e-5, out_dtype)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == before + 1 and got.dtype == out_dtype
    want = ln.layer_norm_plain(x, w, b, 1e-5, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    """bf16 and fp32 are taken (the fp32 tests below); fp16, and operands
    of mixed dtypes, raise naming both accepted types; so do head dims (48:
    no JAX path has it; 80, the vit_h student's, is taken since its port)
    and kernel sizes the kernels were not built for."""
    q16 = _randn(cuda, 1, 2, 16, 32, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_sdpa(q16, q16, q16, torch.zeros((1, 16), device=cuda))
    q = _randn(cuda, 1, 2, 16, 32)
    with pytest.raises(TypeError, match="all of one dtype"):
        fa.flash_sdpa(q, q.float(), q, torch.zeros((1, 16), device=cuda))
    q48 = _randn(cuda, 1, 2, 16, 48)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_sdpa(q48, q48, q48, torch.zeros((1, 16), device=cuda))
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_sdpa(q48.float(), q48.float(), q48.float(), torch.zeros((1, 16), device=cuda))
    q80 = _randn(cuda, 1, 2, 16, 80)
    assert fa.flash_sdpa(q80, q80, q80, torch.zeros((1, 16), device=cuda)).shape == q80.shape
    q256 = _randn(cuda, 1, 1, 16, 256)
    with pytest.raises(ValueError, match="dk, dv"):
        fa.flash_memattn(q256, q256, q256, torch.zeros((1, 16), device=cuda))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_memattn(q256.float(), q256, q256[..., :64], torch.zeros((1, 16), device=cuda))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_memattn(q256.half(), q256.half(), q256[..., :64].half(),
                         torch.zeros((1, 16), device=cuda))
    x = _randn(cuda, 1, 8, 8, 16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        dw.depthwise_conv2d(x.half(), torch.zeros(7, 7, 1, 16, device=cuda),
                            torch.zeros(16, device=cuda))
    with pytest.raises(ValueError, match="kernel"):
        dw.depthwise_conv2d(x, torch.zeros(3, 3, 1, 16, device=cuda), torch.zeros(16, device=cuda))


def _rel_err(got, want):
    """max |got - want| over max |want| (fp32)."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _bwd_inputs(dev, b, lq, lk):
    """q/k/v, a key bias with masked keys 64-255 in row 0 (a 64-key tile of
    the dq kernel and a 128-key block of the wgmma dkv kernel, where Lk
    reaches them), with B > 2 the first half of row 1's keys masked, and a
    fully masked last batch row; the forward's output and lse, and dO as a
    strided (B, H, N, D) view of a (B, N, H * D) gradient, as the fusion
    encoder hands it in."""
    q, k, v = (_randn(dev, b, 8, n, 32) for n in (lq, lk, lk))
    bias = torch.zeros((b, lk), device=dev)
    bias[0, 64:256] = NEG_INF
    if b > 2:
        bias[1, :lk // 2] = NEG_INF
    bias[-1] = NEG_INF
    o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    do = _randn(dev, b, lq, 8 * 32).reshape(b, lq, 8, 32).transpose(1, 2)
    return q, k, v, bias, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("lq,lk", [(5184, 5184), (333, 517), (1, 64), (130, 200), (64, 9)])
def test_flash_sdpa_bwd_kernels_match_plain(cuda, b, lq, lk):
    """dq (and Delta) and dk/dv kernels against the plain backward (dk/dv:
    the wgmma kernel of flash_sdpa_bwd_h.cu): ragged Lq/Lk against the
    64-query tile and the 128-key block, masked key tiles and a masked
    block (skipped, or zeros), a fully masked batch row (zero gradients)
    and a strided dO; dk/dv the same when run again. dQ/dK/dV are bf16 sums
    over Lk or Lq terms in other orders: 2e-2 of each gradient's largest
    magnitude."""
    q, k, v, bias, o, lse, do = _bwd_inputs(cuda, b, lq, lk)
    assert lq == 1 or not do.is_contiguous()
    assert fa.bwd_dkv_kernel(torch.bfloat16, 32) == "flash_sdpa_bwd_h"
    scale = 32 ** -0.5
    n_dq, n_dkv = fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert (fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    assert dk.transpose(1, 2).is_contiguous() and dv.transpose(1, 2).is_contiguous()
    dk2, dv2 = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
    want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, bias, do, lse, want_delta, scale)
    torch.testing.assert_close(delta, want_delta, atol=1e-4, rtol=1e-4)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _rel_err(got, want) < 2e-2
    for g in (dq, dk, dv):
        assert (g[-1] == 0).all()


@pytest.mark.cuda
def test_flash_sdpa_bwd_kernels_refuse_other_head_dims(cuda):
    """Head dims 32, 64, 80 and 256 have backward kernels; another (48)
    raises, in the kernels and in flash_sdpa under autograd, and d=256 is
    taken."""
    q = _randn(cuda, 1, 1, 64, 48)
    bias = torch.zeros((1, 64), device=cuda)
    lse = torch.zeros((1, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_sdpa_bwd_dq(q, q, q, bias, q, lse, q, 0.125)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_sdpa_bwd_dkv(q, q, q, bias, q, lse, lse, 0.125)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_sdpa(q.requires_grad_(), q, q, bias)
    q256 = _randn(cuda, 1, 1, 64, 256).requires_grad_()
    before = fa.flash_sdpa_bwd_dq.launches
    fa.flash_sdpa(q256, q256, q256, bias).float().sum().backward()
    assert fa.flash_sdpa_bwd_dq.launches == before + 1 and q256.grad.shape == q256.shape


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(2, 700), (4, 333)])
def test_flash_sdpa_autograd_matches_plain_autograd(cuda, b, n):
    """flash_sdpa under autograd at d=32 in bf16 (the wgmma forward, then
    the dq kernel and the wgmma dkv kernel) against autograd through the
    plain forward, bf16 in both: within 3e-2 of each gradient's largest
    magnitude (bf16 P and dS against autograd's own rounding points);
    key_bias gets a zero gradient."""
    q, k, v, bias, _, _, _ = _bwd_inputs(cuda, b, n, n)
    w = _randn(cuda, b, 8, n, 32, dtype=torch.float32)
    grads = {}
    for name, fn in (("kernel", fa.flash_sdpa), ("plain", fa.flash_sdpa_plain)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        (fn(*leaves).float() * w).sum().backward()
        grads[name] = [t.grad for t in leaves]
    for got, want in zip(grads["kernel"][:3], grads["plain"][:3]):
        assert _rel_err(got, want) < 3e-2
    assert (grads["kernel"][3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,g_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32),
])
@pytest.mark.parametrize("rows", [20736, 17])
def test_layer_norm_bwd_kernel_matches_plain(cuda, x_dtype, g_dtype, rows):
    """dx per row, dw/db summed over every row (a block's fp32 partials,
    finished in the same launch): 1e-2 as for the forward, dw/db relative
    to their range."""
    x = 3.0 * _randn(cuda, rows, 256, dtype=x_dtype)
    w = 1.0 + 0.1 * _randn(cuda, 256, dtype=torch.float32)
    g = _randn(cuda, rows, 256, dtype=g_dtype)
    before = ln.layer_norm_bwd.launches
    dx, dw, db = ln.layer_norm_bwd(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd.launches == before + 1 and dx.dtype == x_dtype
    want_dx, want_dw, want_db = ln.layer_norm_bwd_plain(x, w, g, 1e-5)
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=TOL, rtol=TOL)
    assert _rel_err(dw, want_dw) < 1e-4 and _rel_err(db, want_db) < 1e-4


@pytest.mark.cuda
def test_layer_norm_autograd_matches_plain_autograd(cuda):
    x = (3.0 * _randn(cuda, 2, 300, 256, dtype=torch.float32)).requires_grad_()
    w = (1.0 + 0.1 * _randn(cuda, 256, dtype=torch.float32)).requires_grad_()
    b = (0.1 * _randn(cuda, 256, dtype=torch.float32)).requires_grad_()
    g = _randn(cuda, 2, 300, 256, dtype=torch.float32)
    fwd, bwd = ln.layer_norm.launches, ln.layer_norm_bwd.launches
    y = ln.layer_norm(x, w, b, 1e-5, torch.bfloat16)
    got = torch.autograd.grad((y.float() * g).sum(), (x, w, b))
    assert (ln.layer_norm.launches, ln.layer_norm_bwd.launches) == (fwd + 1, bwd + 1)
    want = torch.autograd.grad(
        (ln.layer_norm_plain(x, w, b, 1e-5, torch.bfloat16).float() * g).sum(), (x, w, b))
    for a, e in zip(got, want):
        assert _rel_err(a, e) < 1e-2


@pytest.mark.cuda
def test_forward_only_kernels_raise_under_grad(cuda):
    """flash_memattn, flash_memattn_q8 and flash_xattn_rpb have no backward
    (nor do their JAX kernels): under autograd they raise instead of
    returning a tensor cut from the graph; under no_grad they run.
    depthwise_conv2d has its backward now (test_depthwise_autograd_*)."""
    q = _randn(cuda, 1, 1, 64, 256).requires_grad_()
    k = _randn(cuda, 1, 1, 64, 256)
    v = _randn(cuda, 1, 1, 64, 64)
    bias = torch.zeros((1, 64), device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_memattn(q, k, v, bias)
    k_i8, k_scale = fa.quantize_rows(_randn(cuda, 1, 128, 256))  # a padded bank of 128 keys
    v128 = _randn(cuda, 1, 1, 128, 64)
    bias128 = torch.zeros((1, 128), device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_memattn_q8(q, k_i8[:, None], k_scale[..., 0], v128, bias128)
    with torch.no_grad():
        out = fa.flash_memattn_q8(q, k_i8[:, None], k_scale[..., 0], v128, bias128)
        assert out.shape == (1, 1, 64, 64)
    q32 = _randn(cuda, 1, 8, 5, 32).requires_grad_()
    kv = _randn(cuda, 1, 8, 12, 32)
    ey = _randn(cuda, 1, 8, 5, 3, dtype=torch.float32)
    ex = _randn(cuda, 1, 8, 5, 4, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_xattn_rpb(q32, kv, kv, ey, ex, (3, 4))
    with torch.no_grad():
        assert fa.flash_xattn_rpb(q32, kv, kv, ey, ex, (3, 4)).shape == q32.shape


@pytest.mark.cuda
def test_native_hungarian_matches_numpy(cuda):
    """The host C++ solver the matcher takes for predictions on the card
    gives the NumPy solver's assignments bit for bit: random costs, integer
    costs full of ties, and constant padded rows (as the matcher pads the
    targets)."""
    from efficientsam3_tpu_torch.ops import hungarian

    rng = np.random.default_rng(21)
    for trial in range(30):
        t = int(rng.integers(1, 41))
        c = rng.standard_normal((int(rng.integers(1, 12)), t, t + int(rng.integers(0, 160))))
        c = c.astype(np.float32)
        if trial % 3 == 0:
            c = np.round(2 * c).astype(np.float32)
        elif trial % 3 == 1:
            c[:, t // 3:] = 1e6
        assert np.array_equal(hungarian.solve_assignment_native(c),
                              hungarian.solve_assignment_batched(c)), trial


def _q8_inputs(dev, b, lq, lk, dtype=torch.bfloat16):
    """q, the quantized bank of k, raw values as a strided (B, 1, Lk, 64)
    view of a bank, and a key mask: a masked entry and a masked pad tail in
    slot 0, slot 1 empty (all keys masked, zero queries), the rest live."""
    q = _randn(dev, b, 1, lq, 256, dtype=dtype)
    k = _randn(dev, b, 1, lk, 256, dtype=dtype)
    if b > 1:
        q[1] = 0
    k_i8, ks = fa.quantize_rows(k)
    bank = _randn(dev, b, lk, 64, dtype=dtype)
    bias = torch.zeros((b, lk), device=dev)
    bias[0, lk // 4: lk // 2] = NEG_INF
    bias[0, lk - lk // 8:] = NEG_INF
    bias[1:2] = NEG_INF
    return q, k, k_i8, ks[:, 0, :, 0], bank[:, None], bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("lq,lk", [(5184, 36864), (333, 640), (1, 128)])
def test_flash_memattn_q8_kernel_matches_plain(cuda, dtype, lq, lk):
    """The int8 bank kernel (flash_memattn_h.cu's int8-key instantiation, q
    and v bf16 or fp32) against its plain version: the tracker shape, a
    ragged Lq, one row; a masked entry and pad tail (dead tiles skipped), an
    empty slot (zero queries, all keys masked: 0 out, lse -1e9), with and
    without the LSE (the same bits), the output and LSE within TOL (bf16)
    or FP32_TOL (fp32), and within 2e-2 of the output's largest magnitude
    of flash_memattn over the dequantized keys (only q's rounding
    differs)."""
    tol = TOL if dtype == torch.bfloat16 else FP32_TOL
    q, k, k_i8, ks, v, bias = _q8_inputs(cuda, 3, lq, lk, dtype)
    assert fa.memattn_q8_kernel(dtype) == ("flash_memattn_q8_h" if dtype == torch.bfloat16
                                           else "flash_memattn_q8_h_fp32")
    before = fa.flash_memattn_q8.launches
    got, lse = fa.flash_memattn_q8(q, k_i8, ks, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_memattn_q8.launches == before + 1 and got.shape == (3, 1, lq, 64)
    assert got.dtype == dtype
    want, want_lse = fa.flash_memattn_q8_plain(q, k_i8, ks, v, bias, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    assert (got[1] == 0).all() and (lse[1] == NEG_INF).all()
    assert torch.equal(fa.flash_memattn_q8(q, k_i8, ks, v, bias), got)
    k_deq = (k_i8.float() * ks[:, None, :, None]).to(dtype)
    exact = fa.flash_memattn(q, k_deq, v, bias)
    assert _rel_err(got, exact) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_flash_memattn_q8_tile_skip_and_zero_rows(cuda, dtype):
    """A live tile between dead ones gives what the same keys give in a
    bank without the dead tiles around them (walking or skipping dead tiles
    does not change the result), and an all-zero query
    row (scale sm_scale * 1e-8 / 127, logits exactly 0) averages the live
    values."""
    tol = TOL if dtype == torch.bfloat16 else FP32_TOL
    lq, lk = 70, 1024
    q, _, k_i8, ks, v, _ = _q8_inputs(cuda, 2, lq, lk, dtype)
    q[1] = _randn(cuda, 1, lq, 256, dtype=dtype)
    q[0, 0, 3] = 0
    bias = torch.full((2, lk), NEG_INF, device=cuda)
    bias[:, 128:192] = 0.0  # one live 64-key tile
    bias[1, 640:700] = 0.0  # and a ragged stretch over two tiles in slot 1
    got = fa.flash_memattn_q8(q, k_i8, ks, v, bias)
    sub = fa.flash_memattn_q8(q[:1], k_i8[:1, :, 128:256].contiguous(), ks[:1, 128:256].contiguous(),
                              v[:1, :, 128:256], bias[:1, 128:256])
    torch.testing.assert_close(got[:1].float(), sub.float(), atol=tol, rtol=tol)
    mean = v[0, 0, 128:192].float().mean(0)
    torch.testing.assert_close(got[0, 0, 3].float(), mean, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_flash_memattn_q8_reads_strided_inputs(cuda, dtype):
    """q as a merged-heads view, the int8 keys as one layer of a (B, L, S,
    C) bank, v a column slice of a wider tensor: read in place, the same
    bits as contiguous copies."""
    tol = TOL if dtype == torch.bfloat16 else FP32_TOL
    lq, lk = 130, 256
    qfull = _randn(cuda, 2, lq, 512, dtype=dtype)
    q = qfull[..., 256:].reshape(2, lq, 1, 256).transpose(1, 2)
    bank = torch.from_numpy(RNG.integers(-127, 128, (2, 3, lk, 256)).astype(np.int8)).to(cuda)
    k_i8 = bank[:, 1][:, None]
    ks = 0.01 + 0.01 * torch.rand((2, lk), device=cuda)
    v = _randn(cuda, 2, lk, 128, dtype=dtype)[..., 32:96][:, None]
    assert not (q.is_contiguous() or k_i8.is_contiguous() or v.is_contiguous())
    bias = torch.zeros((2, lk), device=cuda)
    got = fa.flash_memattn_q8(q, k_i8, ks, v, bias)
    want = fa.flash_memattn_q8(q.contiguous(), k_i8.contiguous(), ks, v.contiguous(), bias)
    assert torch.equal(got, want)
    torch.testing.assert_close(got.float(),
                               fa.flash_memattn_q8_plain(q, k_i8, ks, v, bias).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_memattn_q8_refuses_what_it_does_not_take(cuda):
    q, _, k_i8, ks, v, bias = _q8_inputs(cuda, 1, 64, 128)
    with pytest.raises(ValueError, match="pre-padded"):
        fa.flash_memattn_q8(q, k_i8[:, :, :100], ks[:, :100], v[:, :, :100], bias[:, :100])
    with pytest.raises(TypeError, match="all of one dtype"):
        fa.flash_memattn_q8(q.float(), k_i8, ks, v, bias)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_memattn_q8(q.half(), k_i8, ks, v.half(), bias)
    with pytest.raises(ValueError, match="dk, dv"):
        fa.flash_memattn_q8(q[..., :128], k_i8[..., :128], ks, v, bias)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_memattn_q8(q, k_i8.to(torch.bfloat16), ks, v, bias)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_memattn_q8(q.clone().requires_grad_(), k_i8, ks, v, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,n_iter", [(768, 256, 2048, 64), (100, 64, 130, 3), (1, 32, 1, 1)])
def test_mma_probe_kernel_matches_plain(cuda, dtype, m, k, n, n_iter):
    """The chained tensor-core product against the same chain of fp32
    matmuls: the probe's shape, ragged m and n, one element. int8 products
    are exact; the chain's fp32 sums round in another order (1e-5 of the
    largest magnitude)."""
    from efficientsam3_tpu_torch.ops import mma_probe

    x, y = mma_probe.probe_operands(dtype, m, k, n, seed=3, device=cuda)
    before = mma_probe.dot_chain.launches
    got = mma_probe.dot_chain(x, y, n_iter)
    torch.cuda.synchronize()
    assert mma_probe.dot_chain.launches == before + 1 and got.shape == (m, n)
    assert _rel_err(got, mma_probe.dot_chain_plain(x, y, n_iter)) < 1e-5


@pytest.mark.cuda
def test_mma_probe_refuses_what_it_does_not_take(cuda):
    from efficientsam3_tpu_torch.ops import mma_probe

    x = torch.zeros((8, 48), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        mma_probe.dot_chain(x, x.T.contiguous())
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        mma_probe.dot_chain(x.float(), x.T.float())
    big = torch.zeros((8, 1024), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        mma_probe.dot_chain(big, big.T.contiguous())


@pytest.mark.cuda
def test_native_host_kernels_match_scipy(cuda):
    """The host library as nvcc builds it on the card's machine: hole
    filling with sprinkle removal, labels and the distance transform against
    scipy on noise masks."""
    from scipy import ndimage

    from efficientsam3_tpu_torch import native
    from efficientsam3_tpu_torch.ops.cc import fill_holes_in_mask_scores_host

    rng = np.random.default_rng(5)
    scores = rng.standard_normal((5, 40, 56)).astype(np.float32)
    for sprinkles in (False, True):
        got = fill_holes_in_mask_scores_host(scores, 6, sprinkles, native=True)
        want = fill_holes_in_mask_scores_host(scores, 6, sprinkles, native=False)
        np.testing.assert_array_equal(got, want)
    mask = rng.random((37, 53)) > 0.4
    labels, n = native.cc_label(mask)
    want_labels, want_n = ndimage.label(mask, structure=np.ones((3, 3), int))
    assert n == want_n and np.array_equal(labels > 0, mask)
    assert len(set(zip(labels[mask].tolist(), want_labels[mask].tolist()))) == n
    np.testing.assert_allclose(native.edt(mask), ndimage.distance_transform_edt(mask), atol=1e-4)


# -------------------------------------------------------------------------
# the tracker's training path: flash_sdpa backward at head dim 256,
# depthwise_conv2d backward, rms_norm_2d forward and backward


def _bwd256_inputs(dev, b, lq, lk, heads=1, slabs=False, dtype=torch.bfloat16):
    """Head dim 256 (bf16, or ``dtype``): q/k/v as strided (B, H, N, 256) views of (B, N, H *
    256) tokens, a key bias with a masked 64-key tile in row 0, a ragged
    masked tail in row 1 and every key of the last row masked (an empty
    object slot), the forward's output and lse, and a strided dO. With
    ``slabs`` every 64-column slab j of v and dO is scaled by 1 + j and of q
    and k by (1 + j) / 2 (so a kernel reading the wrong slab of an operand
    four slabs wide is off by a multiple of its values), and the 128-key
    block 256..384 of row 0 is masked too."""
    def heads_of(n):
        return _randn(dev, b, n, heads * 256, dtype=dtype).reshape(b, n, heads, 256).transpose(1, 2)

    q, k, v, do = heads_of(lq), heads_of(lk), heads_of(lk), heads_of(lq)
    bias = torch.zeros((b, lk), device=dev)
    bias[0, 64:128] = NEG_INF
    bias[1, lk - lk // 3:] = NEG_INF
    bias[-1] = NEG_INF
    if slabs:
        ramp = torch.arange(256, device=dev).div(64, rounding_mode="floor").add(1.0)
        q, k = ((t.float() * ramp / 2).to(t.dtype) for t in (q, k))
        v, do = ((t.float() * ramp).to(t.dtype) for t in (v, do))
        bias[0, 256:384] = NEG_INF
    o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    return q, k, v, bias, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,heads,slabs", [
    (5184, 5184, 1, False), (333, 36352, 1, False), (700, 517, 2, False), (1, 64, 1, False),
    (257, 2000, 1, True), (64, 5184, 2, True)])
def test_flash_sdpa_bwd_d256_kernels_match_plain(cuda, lq, lk, heads, slabs):
    """dq (and Delta) and dk/dv at head dim 256 against the plain backward
    (bf16: the wgmma kernels of flash_sdpa_bwd_wide_h.cu): the tracker's
    self-attention (5184 x 5184) and its plain path's cross-attention
    (36352 keys), strided heads, ragged Lq/Lk (2000 keys: not a multiple of
    the 64-key tile nor of 128), a masked key tile (skipped), a masked
    128-key block, a fully masked batch row (zero gradients), operands whose
    64-column slabs differ in scale; dQ, dK and dV in (B, N, H, D) memory,
    Delta (B, H, Lq) contiguous, and the same bits when run again. Sums of
    bf16 products over Lk or Lq terms in other orders: 2e-2 of each
    gradient's largest magnitude."""
    q, k, v, bias, o, lse, do = _bwd256_inputs(cuda, 3, lq, lk, heads, slabs)
    assert not q.is_contiguous() or heads == 1
    assert fa.bwd_dq_kernel(torch.bfloat16, 256) == "flash_sdpa_bwd_wide_h"
    assert fa.bwd_dkv_kernel(torch.bfloat16, 256) == "flash_sdpa_bwd_wide_h"
    scale = 256 ** -0.5
    n_dq, n_dkv = fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert (fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    for g in (dq, dk, dv):
        assert g.transpose(1, 2).is_contiguous()
    assert delta.shape == lse.shape and delta.is_contiguous()
    dq2, delta2 = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    dk2, dv2 = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    assert all(torch.equal(a, b_) for a, b_ in ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
    want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, bias, do, lse, want_delta, scale)
    torch.testing.assert_close(delta, want_delta, atol=1e-3, rtol=1e-3)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _rel_err(got, want) < 2e-2
        if slabs:  # each slab on its own, against its own largest magnitude
            for j in range(4):
                assert _rel_err(got[..., 64 * j:64 * j + 64], want[..., 64 * j:64 * j + 64]) < 2e-2
    for g in (dq, dk, dv):
        assert (g[-1] == 0).all()
    assert (dk[0, :, 64:128] == 0).all() and (dv[0, :, 64:128] == 0).all()
    if slabs:
        assert (dk[0, :, 256:384] == 0).all() and (dv[0, :, 256:384] == 0).all()


@pytest.mark.cuda
def test_flash_sdpa_d256_autograd_matches_plain_autograd(cuda):
    """flash_sdpa at head dim 256 under autograd (forward kernel, dq and
    dkv kernels) against autograd through the plain forward, bf16 in both:
    within 3e-2 of each gradient's largest magnitude; key_bias gets a zero
    gradient."""
    q, k, v, bias, _, _, _ = _bwd256_inputs(cuda, 3, 600, 900)
    w = _randn(cuda, 3, 1, 600, 256, dtype=torch.float32)
    grads = {}
    for name, fn in (("kernel", fa.flash_sdpa), ("plain", fa.flash_sdpa_plain)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        (fn(*leaves).float() * w).sum().backward()
        grads[name] = [t.grad for t in leaves]
    for got, want in zip(grads["kernel"][:3], grads["plain"][:3]):
        assert _rel_err(got, want) < 3e-2
    assert (grads["kernel"][3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 72, 72, 256), (2, 13, 29, 40), (1, 9, 5, 37), (1, 3, 4, 8)])
def test_depthwise_bwd_matches_plain(cuda, shape):
    """dx (the backward kernel's correlation over the flipped taps) against
    the plain backward, and dw / db (its fp32 sums, finished in the same
    launch) against the plain reductions in fp64: the tracker shape, odd H/W and C
    (the element-copy staging), and a map smaller than the 7x7 kernel. g is
    a loss gradient's size (1e-2), so dx is held relative to its range."""
    c = shape[-1]
    x = _randn(cuda, *shape)
    g = (1e-2 * _randn(cuda, *shape, dtype=torch.float32)).to(torch.bfloat16)
    wk = 0.2 * _randn(cuda, 7, 7, 1, c, dtype=torch.float32)
    before = dw.depthwise_conv2d_bwd.launches
    dx, dwt, db = dw.depthwise_conv2d_bwd(x, wk, g)
    torch.cuda.synchronize()
    assert dw.depthwise_conv2d_bwd.launches == before + 1 and dx.dtype == torch.bfloat16
    want = dw.depthwise_conv2d_bwd_plain(x, wk, g)
    assert _rel_err(dx, want[0]) < TOL
    exact = dw.depthwise_conv2d_bwd_plain(x.double(), wk.double(), g.double())
    assert _rel_err(dwt, exact[1]) < 1e-5 and _rel_err(db, exact[2]) < 1e-5
    with pytest.raises(TypeError, match="x's dtype"):
        dw.depthwise_conv2d_bwd(x, wk, g.float())


@pytest.mark.cuda
def test_depthwise_autograd_matches_plain_autograd(cuda):
    """depthwise_conv2d under autograd (forward kernel, the backward kernel's
    dx and fp32 dw / db) against autograd through the plain forward; taps and bias in
    bf16 as CXBlock holds them, so their gradients come back bf16."""
    x = _randn(cuda, 2, 30, 41, 64)
    wk = (0.2 * _randn(cuda, 7, 7, 1, 64, dtype=torch.float32)).to(torch.bfloat16)
    bias = (0.1 * _randn(cuda, 64, dtype=torch.float32)).to(torch.bfloat16)
    proj = _randn(cuda, 2, 30, 41, 64, dtype=torch.float32)
    grads = {}
    for name, fn in (("kernel", dw.depthwise_conv2d), ("plain", dw.depthwise_conv2d_plain)):
        leaves = [t.detach().clone().requires_grad_() for t in (x, wk, bias)]
        fwd, bwd = dw.depthwise_conv2d.launches, dw.depthwise_conv2d_bwd.launches
        (fn(*leaves).float() * proj).sum().backward()
        if name == "kernel":
            assert (dw.depthwise_conv2d.launches, dw.depthwise_conv2d_bwd.launches) == (
                fwd + 1, bwd + 1)
        grads[name] = [t.grad for t in leaves]
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert got.dtype == want.dtype and _rel_err(got, want) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 72, 72, 256), (4, 63, 63, 128), (3, 5, 7, 40)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_2d_kernels_match_plain(cuda, shape, dtype):
    """Forward (out, rstd) and backward (dx, dw, db) against the plain
    versions: the tracker's map, EV-M's stride-16 map at batch 4 (15876
    rows: a ragged last program), and a channel count that is not a power
    of two. out / dx round to x's dtype after sums in other orders (1e-2);
    rstd 1e-5; dw / db are fp32 sums of per-program partials, 1e-4 of
    their range."""
    c = shape[-1]
    x = 3.0 * _randn(cuda, *shape, dtype=dtype)
    w = 1.0 + 0.1 * _randn(cuda, c, dtype=torch.float32)
    b = 0.1 * _randn(cuda, c, dtype=torch.float32)
    g = _randn(cuda, *shape, dtype=dtype)
    fwd, bwd = rn.rms_norm_2d.launches, rn.rms_norm_2d_bwd.launches
    out = rn.rms_norm_2d(x, w, b)
    _, rstd = rn._fwd(x, w, b, 1e-5)
    dx, dwt, db = rn.rms_norm_2d_bwd(x, w, rstd, g)
    torch.cuda.synchronize()
    assert (rn.rms_norm_2d.launches, rn.rms_norm_2d_bwd.launches) == (fwd + 2, bwd + 1)
    want, want_rstd = rn.rms_norm_2d_plain(x, w, b, return_rstd=True)
    assert out.dtype == dtype and dx.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(rstd, want_rstd, atol=1e-5, rtol=1e-5)
    want_dx, want_dw, want_db = rn.rms_norm_2d_bwd_plain(x, w, want_rstd, g)
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=TOL, rtol=TOL)
    assert _rel_err(dwt, want_dw) < 1e-4 and _rel_err(db, want_db) < 1e-4


@pytest.mark.cuda
def test_rms_norm_2d_autograd_matches_plain_autograd(cuda):
    x = (3.0 * _randn(cuda, 2, 17, 19, 128, dtype=torch.float32)).to(torch.bfloat16)
    x.requires_grad_()
    w = (1.0 + 0.1 * _randn(cuda, 128, dtype=torch.float32)).requires_grad_()
    b = (0.1 * _randn(cuda, 128, dtype=torch.float32)).requires_grad_()
    g = _randn(cuda, 2, 17, 19, 128, dtype=torch.float32)
    fwd, bwd = rn.rms_norm_2d.launches, rn.rms_norm_2d_bwd.launches
    got = torch.autograd.grad((rn.rms_norm_2d(x, w, b).float() * g).sum(), (x, w, b))
    assert (rn.rms_norm_2d.launches, rn.rms_norm_2d_bwd.launches) == (fwd + 1, bwd + 1)
    want = torch.autograd.grad((rn.rms_norm_2d_plain(x, w, b).float() * g).sum(), (x, w, b))
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and _rel_err(a, e) < 1e-2


# -------------------------------------------------------------------------
# fp32 operands: every attention and depthwise kernel has an fp32
# instantiation (split bf16 parts: three products each, about 2^-16 of a
# product's magnitude; depthwise is fp32 FMA either way). Each is held to
# its plain version in fp32 at 1e-4 (atol and rtol), gradients at 1e-4 of
# their largest magnitude.

FP32_TOL = 1e-4


def _mask_rows(dev, b, lk):
    """A key bias with a masked 64-key tile in row 0, a ragged masked tail
    in row 1 and every key of the last row masked."""
    bias = torch.zeros((b, lk), device=dev)
    bias[0, 64:128] = NEG_INF
    bias[1, lk - lk // 3:] = NEG_INF
    bias[-1] = NEG_INF
    return bias


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,lq,lk", [(32, 8, 5184, 5184), (32, 8, 333, 517), (32, 2, 1, 64),
                                       (256, 1, 5184, 5184), (256, 1, 70, 36352),
                                       (256, 1, 333, 517)])
def test_flash_sdpa_fp32_kernel_matches_plain(cuda, d, h, lq, lk):
    """fp32 q/k/v at d=32 and d=256 (the split-bf16 wgmma kernels of
    flash_sdpa_h_fp32.cu): output fp32 and LSE against the plain version,
    ragged Lq/Lk, a masked tile, a ragged masked tail, a fully masked
    row."""
    q, k, v = (_randn(cuda, 3, h, n, d, dtype=torch.float32) for n in (lq, lk, lk))
    bias = _mask_rows(cuda, 3, lk)
    assert fa.sdpa_kernel(torch.float32, d) == "flash_sdpa_h_fp32"
    before = fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_sdpa.launches == before + 1 and got.dtype == torch.float32
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, atol=FP32_TOL, rtol=FP32_TOL)
    assert (got[-1] == 0).all() and (lse[-1] == NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d,lq,lk", [(32, 5184, 5184), (32, 333, 517), (256, 333, 36352),
                                     (256, 700, 517), (64, 333, 517), (80, 333, 517),
                                     (64, 130, 70), (80, 64, 9), (80, 200, 2000), (64, 1, 300)])
def test_flash_sdpa_bwd_fp32_kernels_match_plain(cuda, d, lq, lk):
    """The dq (and Delta) and dk/dv kernels' fp32 instantiations (d=32, 64
    and 80: the split-bf16 wgmma kernels of flash_sdpa_bwd_dq_h_fp32.cu and
    flash_sdpa_bwd_h_fp32.cu; d=256: those of flash_sdpa_bwd_wide_h_fp32.cu)
    against the plain backward in fp32: strided dO, ragged Lq/Lk, a masked
    64-key tile, a ragged masked tail, a fully masked row (zero gradients),
    dQ / dK / dV in (B, N, H, D) memory, Delta within FP32_TOL, the same
    bits when run again."""
    h = {32: 8, 64: 2, 80: 3, 256: 1}[d]
    q, k, v = (_randn(cuda, 3, h, n, d, dtype=torch.float32) for n in (lq, lk, lk))
    bias = _mask_rows(cuda, 3, lk)
    o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    do = _randn(cuda, 3, lq, h * d, dtype=torch.float32).reshape(3, lq, h, d).transpose(1, 2)
    scale = d ** -0.5
    want = (("flash_sdpa_bwd_wide_h_fp32",) * 2 if d == 256
            else ("flash_sdpa_bwd_dq_h_fp32", "flash_sdpa_bwd_h_fp32"))
    assert (fa.bwd_dq_kernel(torch.float32, d), fa.bwd_dkv_kernel(torch.float32, d)) == want
    n_dq, n_dkv = fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert (fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    for g in (dq, dk, dv):
        assert g.transpose(1, 2).is_contiguous()
    dq2, delta2 = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    dk2, dv2 = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    assert all(torch.equal(a, b_) for a, b_ in ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
    want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, bias, do, lse, want_delta, scale)
    torch.testing.assert_close(delta, want_delta, atol=FP32_TOL, rtol=FP32_TOL)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel_err(got, want) < FP32_TOL
        assert (got[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "slabs", "all_live", "nan_scratch"])
def test_flash_sdpa_bwd_fp32_d256_cases_match_plain(cuda, case):
    """The fp32 d=256 kernels (flash_sdpa_bwd_wide_h_fp32.cu) against the
    plain backward in fp32, each gradient within FP32_TOL of its largest
    magnitude and Delta within FP32_TOL: ``ragged`` 2000 keys (a multiple of
    neither the 32-key tile nor 64) with a masked 64-key block in row 0, a
    ragged masked tail and an empty slot; ``slabs`` operands whose 64-column
    slabs differ in scale and a masked 128-key block, two strided heads;
    ``all_live`` 36352 keys with every key live, where a dQ accumulated
    with the tensor cores' truncating adds would carry its bias past the
    tolerance; ``nan_scratch`` the ragged case after a NaN-filled block the
    size of the split copies was allocated and freed, so that a row the
    split pass leaves unwritten but a kernel reads shows as NaN. Zero
    gradients on masked keys and the empty slot."""
    f32 = torch.float32
    if case == "all_live":
        q, k, v = (_randn(cuda, 2, 1, n, 256, dtype=f32) for n in (333, 36352, 36352))
        bias = torch.zeros((2, 36352), device=cuda)
        o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
        do = _randn(cuda, 2, 333, 256, dtype=f32).reshape(2, 333, 1, 256).transpose(1, 2)
    elif case == "slabs":
        q, k, v, bias, o, lse, do = _bwd256_inputs(cuda, 3, 64, 5184, 2, True, dtype=f32)
    else:
        q, k, v, bias, o, lse, do = _bwd256_inputs(cuda, 3, 257, 2000, dtype=f32)
    scale = 256 ** -0.5
    if case == "nan_scratch":  # four split copies' bytes of 0xFF (bf16 NaN), freed
        n_bytes = 2 * 2 * k.numel() * 2 + 2 * 2 * q.numel() * 2
        junk = torch.full((n_bytes,), 255, dtype=torch.uint8, device=cuda)
        del junk
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    torch.cuda.synchronize()
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
    want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, bias, do, lse, want_delta, scale)
    torch.testing.assert_close(delta, want_delta, atol=FP32_TOL, rtol=FP32_TOL)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == f32 and got.shape == want.shape and torch.isfinite(got).all()
        assert got.transpose(1, 2).is_contiguous()
        assert _rel_err(got, want) < FP32_TOL
        if case == "slabs":  # each slab on its own, against its own largest magnitude
            for j in range(4):
                assert _rel_err(got[..., 64 * j:64 * j + 64], want[..., 64 * j:64 * j + 64]) < FP32_TOL
    if case != "all_live":
        for g in (dq, dk, dv):
            assert (g[-1] == 0).all()
        assert (dk[0, :, 64:128] == 0).all() and (dv[0, :, 64:128] == 0).all()
    if case == "slabs":
        assert (dk[0, :, 256:384] == 0).all() and (dv[0, :, 256:384] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 32, 64, 80])
def test_split_parts_kernel_matches_plain(cuda, d):
    """The split pass (flash_sdpa_bwd_wide_h_fp32.cu) against its plain
    version bit for bit, on a strided (B, H, N, d) view holding normals,
    subnormals, zeros and large magnitudes: every row with tile 0 (d=80:
    10 lanes a row, 25 rows a block, 200 rows not a multiple of 25 a
    block's worth at each (batch, head)); at d=256 with tile 32 the rows of
    the 32-row tiles that hold a live key (row 0's keys 32..63 and the whole
    of row 1 masked here, keys past N ignored)."""
    b, n, h = 2, 203, 2
    x = _randn(cuda, b, n, h * d, dtype=torch.float32)
    x[0, :5] = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 3e38], device=cuda)[:, None]
    x = x.reshape(b, n, h, d).transpose(1, 2)
    want = fa.split_parts_plain(x)
    before = fa.split_parts.launches
    got = fa.split_parts(x)
    torch.cuda.synchronize()
    assert fa.split_parts.launches == before + 1 and got.shape == (2, b, h, n, d)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if d != 256:
        return
    bias = torch.zeros((b, 208), device=cuda)
    bias[0, 32:64] = NEG_INF
    bias[1] = NEG_INF
    bias[:, n:] = NEG_INF
    got = fa.split_parts(x, bias, 32)
    torch.cuda.synchronize()
    live = torch.ones((b, n), dtype=torch.bool, device=cuda)
    live[0, 32:64] = False
    live[1] = False
    sel = live[None, :, None, :, None].expand_as(got)
    assert torch.equal(got.view(torch.int16)[sel], want.view(torch.int16)[sel])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 256])
def test_flash_sdpa_fp32_autograd_matches_plain_autograd(cuda, d):
    """flash_sdpa under autograd in fp32 (forward kernel, then the dq and
    dkv kernels) against autograd through the plain forward in fp32."""
    h = 8 if d == 32 else 1
    q, k, v = (_randn(cuda, 2, h, 600, d, dtype=torch.float32) for _ in range(3))
    bias = _mask_rows(cuda, 2, 600)
    w = _randn(cuda, 2, h, 600, d, dtype=torch.float32)
    grads = {}
    for name, fn in (("kernel", fa.flash_sdpa), ("plain", fa.flash_sdpa_plain)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves, bias) * w).sum().backward()
        grads[name] = [t.grad for t in leaves]
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert got.dtype == torch.float32 and _rel_err(got, want) < FP32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(5184, 36864), (333, 517)])
def test_flash_memattn_fp32_kernels_match_plain(cuda, lq, lk):
    """flash_memattn and flash_memattn_q8 with fp32 q and v (q quantized
    from fp32 in the q8 prologue, v on split parts): outputs and LSE
    against their plain versions, a masked entry and tail, an empty slot."""
    lk_q8 = fa.padded_bank_len(lk)
    q, k, k_i8, ks, v, bias = (t.float() if t.is_floating_point() and t.dtype != torch.float32
                               else t for t in _q8_inputs(cuda, 3, lq, lk_q8))
    before = (fa.flash_memattn.launches, fa.flash_memattn_q8.launches)
    got, lse = fa.flash_memattn(q, k, v, bias, return_lse=True)
    got8, lse8 = fa.flash_memattn_q8(q, k_i8, ks, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert (fa.flash_memattn.launches, fa.flash_memattn_q8.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert got.dtype == got8.dtype == torch.float32
    want, want_lse = fa.flash_memattn_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, atol=FP32_TOL, rtol=FP32_TOL)
    want8, want_lse8 = fa.flash_memattn_q8_plain(q, k_i8, ks, v, bias, return_lse=True)
    torch.testing.assert_close(got8, want8, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(lse8, want_lse8, atol=FP32_TOL, rtol=FP32_TOL)
    assert (got[1] == 0).all() and (got8[1] == 0).all() and (lse8[1] == NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lq,hw", [(201, (72, 72)), (7, (3, 5))])
def test_flash_xattn_rpb_fp32_kernel_matches_plain(cuda, lq, hw):
    b, h = 2, 8
    lk = hw[0] * hw[1]
    q, k, v = (_randn(cuda, b, h, n, 32, dtype=torch.float32) for n in (lq, lk, lk))
    ey = _randn(cuda, b, h, lq, hw[0], dtype=torch.float32)
    ex = _randn(cuda, b, h, lq, hw[1], dtype=torch.float32)
    before = fa.flash_xattn_rpb.launches
    got = fa.flash_xattn_rpb(q, k, v, ey, ex, hw)
    torch.cuda.synchronize()
    assert fa.flash_xattn_rpb.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, fa.flash_xattn_rpb_plain(q, k, v, ey, ex, hw),
                               atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 72, 72, 256), (2, 13, 29, 40), (1, 9, 5, 37), (1, 3, 4, 8)])
def test_depthwise_fp32_kernels_match_plain(cuda, shape):
    """The forward and backward kernels' fp32 instantiations: the tracker
    shape, odd H/W and C (element copies), a map
    smaller than the 7x7 kernel; fp32 FMA on both sides."""
    c = shape[-1]
    x = _randn(cuda, *shape, dtype=torch.float32)
    g = 1e-2 * _randn(cuda, *shape, dtype=torch.float32)
    wk = 0.2 * _randn(cuda, 7, 7, 1, c, dtype=torch.float32)
    bias = 0.1 * _randn(cuda, c, dtype=torch.float32)
    fwd, bwd = dw.depthwise_conv2d.launches, dw.depthwise_conv2d_bwd.launches
    got = dw.depthwise_conv2d(x, wk, bias)
    dx, dwt, db = dw.depthwise_conv2d_bwd(x, wk, g)
    torch.cuda.synchronize()
    assert (dw.depthwise_conv2d.launches, dw.depthwise_conv2d_bwd.launches) == (fwd + 1, bwd + 1)
    assert got.dtype == dx.dtype == torch.float32
    torch.testing.assert_close(got, dw.depthwise_conv2d_plain(x, wk, bias), atol=FP32_TOL,
                               rtol=FP32_TOL)
    want = dw.depthwise_conv2d_bwd_plain(x, wk, g)
    assert _rel_err(dx, want[0]) < FP32_TOL
    assert _rel_err(dwt, want[1]) < FP32_TOL and _rel_err(db, want[2]) < FP32_TOL


# -------------------------------------------------------------------------
# flash_sdpa forward at d=32 in bf16: the wgmma / TMA kernel (flash_sdpa_h.cu)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("lq,lk", [(5184, 5184), (333, 517), (130, 70), (1, 64), (200, 9)])
def test_flash_sdpa_h_kernel_matches_plain(cuda, b, lq, lk):
    """The wgmma kernel against the plain version: Lq and Lk ragged
    against the 128-row block and the 64-key tile, key tiles masked in the
    middle (skipped, never loaded), a ragged masked tail, with B=4 a batch
    row whose keys are all masked (0 out, lse -1e9), and the LSE."""
    q, k, v = (_randn(cuda, b, 8, n, 32) for n in (lq, lk, lk))
    bias = torch.zeros((b, lk), device=cuda)
    bias[0, 64:192] = NEG_INF  # two whole tiles (when Lk reaches them)
    bias[0, lk - lk // 5:] = NEG_INF
    if b > 1:
        bias[1, :lk // 2] = NEG_INF
        bias[-1] = NEG_INF
    assert fa.sdpa_kernel(torch.bfloat16, 32) == "flash_sdpa_h"
    before = fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_sdpa.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.transpose(1, 2).is_contiguous()
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)
    if b > 1:
        assert (got[-1] == 0).all() and (lse[-1] == NEG_INF).all()
    assert torch.equal(fa.flash_sdpa(q, k, v, bias), got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 5184), (4, 300)])
def test_flash_sdpa_h_reads_strided_heads(cuda, b, n):
    """q, k and v as split_heads views of separate (B, N, 8 * 32) token
    maps (heads interleaved in each row: TMA reads them in place), the
    output as a (B, N, H, D)-ordered view."""
    q, k, v = (_randn(cuda, b, n, 8 * 32).reshape(b, n, 8, 32).transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    bias = torch.zeros((b, n), device=cuda)
    bias[:, n // 3: n // 2] = NEG_INF
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)


# -------------------------------------------------------------------------
# flash_sdpa forward at d=64: the SAM3 teacher's ViTDet global blocks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, TOL), (torch.float32, FP32_TOL)],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("lq,lk", [(5184, 5184), (4900, 4900), (333, 517), (130, 70), (1, 64),
                                   (200, 9)])
def test_flash_sdpa_d64_kernel_matches_plain(cuda, dtype, tol, b, lq, lk):
    """d=64 with 16 heads against the plain version (bf16: the wgmma kernel
    with the 128-byte swizzle; fp32: the split-bf16 wgmma kernel): ragged Lq and Lk
    against the 128-row block and the 64-key tile (4900: the vit_b / vit_l
    students' global blocks at 1120^2, a tail of 36 keys and 36 rows), a
    masked middle tile (skipped), a ragged masked tail, with B=2 a batch
    row whose keys are all
    masked (0 out, lse -1e9), and the LSE. V is random, so every column
    differs and a V read across the wrong rows or swizzle shows."""
    q, k, v = (_randn(cuda, b, 16, n, 64, dtype=dtype) for n in (lq, lk, lk))
    bias = torch.zeros((b, lk), device=cuda)
    bias[0, 64:128] = NEG_INF
    bias[0, lk - lk // 5:] = NEG_INF
    if b > 1:
        bias[-1] = NEG_INF
    assert fa.sdpa_kernel(dtype, 64) == ("flash_sdpa_h" if dtype == torch.bfloat16
                                         else "flash_sdpa_h_fp32")
    before = fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_sdpa.launches == before + 1
    assert got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    if b > 1:
        assert (got[-1] == 0).all() and (lse[-1] == NEG_INF).all()
    assert torch.equal(fa.flash_sdpa(q, k, v, bias), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, TOL), (torch.float32, FP32_TOL)],
                         ids=["bf16", "fp32"])
def test_flash_sdpa_d64_reads_vitdet_qkv_views(cuda, dtype, tol):
    """q, k and v as ViTAttention makes them: views of one packed (B, N,
    3 * 16 * 64) qkv projection (strides over (B, H, N), D contiguous),
    read in place; the output a (B, N, H, D)-ordered view."""
    b, n = 1, 2304
    qkv = _randn(cuda, b, n, 3 * 16 * 64, dtype=dtype).reshape(b, n, 3, 16, 64)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    assert not v.is_contiguous()
    bias = torch.zeros((b, n), device=cuda)
    got = fa.flash_sdpa(q, k, v, bias)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), fa.flash_sdpa_plain(q, k, v, bias).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(4900, 4900), (130, 70)])
def test_flash_sdpa_d80_reads_every_slab(cuda, lq, lk):
    """The bf16 d=80 wgmma kernel reads a 160-byte row as five 16-column
    slabs (32-byte swizzle), V as an MN-major B operand of N = 80 across
    them: here each slab of q, k and v has its own scale (v's x1 .. x13,
    columns 64-79 the largest), so that a slab read through a wrong
    descriptor, or columns 64-79 missed, shows in the output and the LSE.
    The output is compared divided by its column's v scale: P's bf16
    rounding errs in proportion to v, so this is TOL at the unit scale of
    test_flash_sdpa_d80_kernel_matches_plain, while a slab mix-up errs by
    up to 13x the output."""
    q, k, v = (_randn(cuda, 1, 16, n, 80, dtype=torch.float32) for n in (lq, lk, lk))
    w = torch.tensor([1.0, 0.5, 0.25, 0.75, 0.3], device=cuda).repeat_interleave(16)
    q, k = (q * w).to(torch.bfloat16), (k * w.flip(0)).to(torch.bfloat16)
    v_scale = torch.arange(1, 14, 3, device=cuda).float().repeat_interleave(16)
    v = (v * v_scale).to(torch.bfloat16)
    bias = torch.zeros((1, lk), device=cuda)
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    assert want[..., 64:].abs().amax() > 2 * want[..., :16].abs().amax()
    torch.testing.assert_close(got.float() / v_scale, want.float() / v_scale, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,d", [("flash_sdpa_h", 32), ("flash_sdpa_h", 64),
                                      ("flash_sdpa_h", 80), ("flash_sdpa_h", 256),
                                      ("flash_sdpa_h_fp32", 32), ("flash_sdpa_h_fp32", 64),
                                      ("flash_sdpa_h_fp32", 80), ("flash_sdpa_bwd_h", 32),
                                      ("flash_sdpa_bwd_h", 64), ("flash_sdpa_bwd_h", 80),
                                      ("flash_sdpa_bwd_dq_h", 32), ("flash_sdpa_bwd_dq_h", 64),
                                      ("flash_sdpa_bwd_dq_h", 80), ("flash_sdpa_bwd_h_fp32", 32),
                                      ("flash_sdpa_bwd_h_fp32", 64), ("flash_sdpa_bwd_h_fp32", 80),
                                      ("flash_sdpa_bwd_dq_h_fp32", 32),
                                      ("flash_sdpa_bwd_dq_h_fp32", 64),
                                      ("flash_sdpa_bwd_dq_h_fp32", 80),
                                      ("flash_sdpa_bwd_dq_wide_h", 256),
                                      ("flash_sdpa_bwd_dkv_wide_h", 256),
                                      ("flash_sdpa_bwd_dq_wide_f32", 256),
                                      ("flash_sdpa_bwd_dkv_wide_f32", 256),
                                      ("flash_sdpa_h_fp32", 256), ("flash_memattn_h", 256),
                                      ("flash_memattn_h_fp32", 256), ("flash_memattn_q8_h", 256),
                                      ("flash_memattn_q8_h_fp32", 256)])
def test_wgmma_kernels_fit_without_spills(cuda, kernel, d):
    """The wgmma kernels as built: no registers spilled to local memory, at
    least one block of them resident an SM at the main path's 5184 keys
    (the bf16 forward at d=32 and 64: 2, its design; at d=80 1, whose O
    accumulator would spill at 2; the d=256 forward and dq kernels also at
    the clip's 36352, the bank kernels at the padded bank's 36864; the
    d=64 / d=80 dq kernels and the fp32 forward at vit_h's 4900 as
    well; the bf16 dq kernel at d=32 is the Stage-3 step's, the int8 bank
    kernels in both dtypes the [pcs] and [fp32] sessions')."""
    if kernel in ("flash_sdpa_bwd_dq_h", "flash_sdpa_bwd_dq_h_fp32", "flash_sdpa_h_fp32"):
        assert fa.kernel_resources(kernel, d, 4900)["spill_bytes"] == 0
    if kernel in ("flash_sdpa_bwd_dq_wide_h", "flash_sdpa_bwd_dq_wide_f32") or d == 256:
        assert fa.kernel_resources(kernel, d, 36352)["blocks_per_sm"] >= 1
    if kernel.startswith("flash_memattn"):
        res = fa.kernel_resources(kernel, d, 36864)
        assert res["spill_bytes"] == 0 and res["blocks_per_sm"] >= 1, res
    res = fa.kernel_resources(kernel, d, 5184)
    assert res["spill_bytes"] == 0, res
    assert res["blocks_per_sm"] >= (2 if (kernel, d) in (("flash_sdpa_h", 32),
                                                         ("flash_sdpa_h", 64)) else 1), res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_tiny_teacher_on_card_matches_cpu(cuda, dtype):
    """A tiny SAM3 teacher whose 48x48 token grid (672^2) sends the trunk's
    two global blocks through flash_sdpa at d=64 (2304^2 scores, above
    sdpa's threshold), on the card against the same model in fp32 on the
    CPU: fp32 within 1e-3 of each output's largest magnitude (at least 1),
    bf16 within the bounds chip_smoke.py holds its tiny EV-M to."""
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.models.geometry import Prompt
    from efficientsam3_tpu_torch.models.sam3_image import Sam3ImageModel
    from efficientsam3_tpu_torch.models.vitdet import ViTTrunk

    torch.backends.cudnn.allow_tf32 = False  # the neck's convolutions in fp32

    def tiny(dt):
        trunk = ViTTrunk(embed_dim=128, depth=4, num_heads=2, window_size=16,
                         global_att_blocks=(1, 3), pretrain_grid=16, dtype=dt)
        return Sam3ImageModel(trunk, text_encoder_type=None, text_context_length=16,
                              fusion_layers=2, decoder_layers=2, trunk_dim=128, dtype=dt,
                              text_tower=dict(width=64, heads=4, layers=2)).eval()

    ref_model = init_parameters(tiny(None), 1)
    model = tiny(dtype).to(cuda)
    model.load_state_dict(ref_model.state_dict())
    img = torch.from_numpy(RNG.standard_normal((1, 672, 672, 3)).astype(np.float32))
    tok = torch.zeros((1, 16), dtype=torch.long)
    tok[0, :4] = torch.tensor([49406, 320, 1125, 49407])
    prompt = Prompt.empty(1, 2, 2).with_box(0, 0, [0.5, 0.45, 0.4, 0.3])
    with torch.inference_mode():
        ref = ref_model(img, tok, prompt)
        before = fa.flash_sdpa.launches
        feats = model.encode_image(img.to(cuda))
        torch.cuda.synchronize()
        assert fa.flash_sdpa.launches == before + 2
        got = model.ground(feats["fpn"], feats["pos"], *model.encode_text(tok.to(cuda)),
                           prompt.to(cuda))
    bounds = ({"pred_boxes": 1e-3, "pred_logits": 1e-3, "pred_masks": 1e-3}
              if dtype == torch.float32 else
              {"pred_boxes": 5e-2, "pred_logits": 2.5e-1, "presence_logit_dec": 2.5e-1})
    for key, tol in bounds.items():
        want = ref[key].float()
        err = (got[key].float().cpu() - want).abs().max().item()
        assert err <= tol * max(1.0, want.abs().max().item()), (key, err)


# -------------------------------------------------------------------------
# flash_sdpa forward at d=80: the vit_h SAM1 student's global blocks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, TOL), (torch.float32, FP32_TOL)],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("lq,lk", [(4900, 4900), (333, 517), (130, 70), (1, 64), (200, 9)])
def test_flash_sdpa_d80_kernel_matches_plain(cuda, dtype, tol, b, lq, lk):
    """d=80 with 16 heads (bf16: the wgmma kernel of csrc/flash_sdpa_h.cu,
    five 32-byte-swizzled slabs a tile; fp32: the register kernel of
    csrc/flash_sdpa.cu) against the plain version: vit_h's 4900 tokens (a
    ragged tail of 36), ragged Lq and Lk, a masked middle tile (skipped), a
    ragged masked tail, with B=2 a batch row whose keys are all masked (0
    out, lse -1e9), and the LSE."""
    q, k, v = (_randn(cuda, b, 16, n, 80, dtype=dtype) for n in (lq, lk, lk))
    bias = torch.zeros((b, lk), device=cuda)
    bias[0, 64:128] = NEG_INF
    bias[0, lk - lk // 5:] = NEG_INF
    if b > 1:
        bias[-1] = NEG_INF
    assert fa.sdpa_kernel(dtype, 80) == ("flash_sdpa_h" if dtype == torch.bfloat16
                                         else "flash_sdpa_h_fp32")
    before = fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_sdpa.launches == before + 1
    assert got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    if b > 1:
        assert (got[-1] == 0).all() and (lse[-1] == NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, TOL), (torch.float32, FP32_TOL)],
                         ids=["bf16", "fp32"])
def test_flash_sdpa_d80_reads_vitdet_qkv_views(cuda, dtype, tol):
    """q, k and v as the vit_h student's ViTAttention makes them: views of
    one packed (B, N, 3 * 16 * 80) qkv projection, read in place."""
    b, n = 1, 2116
    qkv = _randn(cuda, b, n, 3 * 16 * 80, dtype=dtype).reshape(b, n, 3, 16, 80)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    bias = torch.zeros((b, n), device=cuda)
    got = fa.flash_sdpa(q, k, v, bias)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), fa.flash_sdpa_plain(q, k, v, bias).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(4900, 4900), (130, 70)])
def test_flash_sdpa_d80_reads_every_slab(cuda, lq, lk):
    """The bf16 d=80 wgmma kernel reads a 160-byte row as five 16-column
    slabs (32-byte swizzle), V as an MN-major B operand of N = 80 across
    them: here each slab of q, k and v has its own scale (v's x1 .. x13,
    columns 64-79 the largest), so that a slab read through a wrong
    descriptor, or columns 64-79 missed, shows in the output and the LSE.
    The output is compared divided by its column's v scale: P's bf16
    rounding errs in proportion to v, so this is TOL at the unit scale of
    test_flash_sdpa_d80_kernel_matches_plain, while a slab mix-up errs by
    up to 13x the output."""
    q, k, v = (_randn(cuda, 1, 16, n, 80, dtype=torch.float32) for n in (lq, lk, lk))
    w = torch.tensor([1.0, 0.5, 0.25, 0.75, 0.3], device=cuda).repeat_interleave(16)
    q, k = (q * w).to(torch.bfloat16), (k * w.flip(0)).to(torch.bfloat16)
    v_scale = torch.arange(1, 14, 3, device=cuda).float().repeat_interleave(16)
    v = (v * v_scale).to(torch.bfloat16)
    bias = torch.zeros((1, lk), device=cuda)
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    assert want[..., 64:].abs().amax() > 2 * want[..., :16].abs().amax()
    torch.testing.assert_close(got.float() / v_scale, want.float() / v_scale, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, FP32_TOL)],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 80])
def test_flash_sdpa_d64_d80_autograd_matches_plain(cuda, dtype, tol, d):
    """flash_sdpa under autograd at d=64 and d=80 (the forward kernel, then
    the wgmma dq kernel, flash_sdpa_bwd_dq_h.cu in bf16 and
    flash_sdpa_bwd_dq_h_fp32.cu in fp32, and the wgmma dkv kernel,
    flash_sdpa_bwd_h.cu in bf16 and flash_sdpa_bwd_h_fp32.cu in fp32: 1
    launch each) against
    autograd through the plain forward in the same dtype, q/k/v strided
    views of a packed qkv as ViTAttention hands them in: bf16 within 3e-2
    of each gradient's largest magnitude (bf16 P and dS against autograd's
    own rounding points), fp32 within FP32_TOL; key_bias gets a zero
    gradient."""
    b, h, n = 2, 4, 700
    packed = _randn(cuda, b, n, 3, h, d, dtype=dtype)
    bias = _mask_rows(cuda, b, n)
    w = _randn(cuda, b, h, n, d, dtype=torch.float32)
    bf16 = dtype == torch.bfloat16
    assert fa.bwd_dq_kernel(dtype, d) == ("flash_sdpa_bwd_dq_h" if bf16
                                          else "flash_sdpa_bwd_dq_h_fp32")
    assert fa.bwd_dkv_kernel(dtype, d) == ("flash_sdpa_bwd_h" if bf16 else "flash_sdpa_bwd_h_fp32")
    grads = {}
    for name, fn in (("kernel", fa.flash_sdpa), ("plain", fa.flash_sdpa_plain)):
        qkv = packed.clone().requires_grad_()
        kb = bias.clone().requires_grad_()
        before = (fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches)
        (fn(*qkv.permute(2, 0, 3, 1, 4), kb).float() * w).sum().backward()
        torch.cuda.synchronize()
        after = (fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches)
        assert after == ((before[0] + 1, before[1] + 1) if name == "kernel" else before)
        grads[name] = (qkv.grad, kb.grad)
    for i in range(3):
        got, want = grads["kernel"][0][:, :, i], grads["plain"][0][:, :, i]
        assert got.dtype == dtype and _rel_err(got, want) < tol
        assert (got[-1] == 0).all()
    assert (grads["kernel"][1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, FP32_TOL)],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("d,h,lq,lk", [(64, 16, 5184, 5184), (80, 16, 4900, 4900),
                                       (64, 2, 333, 517), (80, 2, 333, 517), (64, 2, 1, 64),
                                       (80, 3, 130, 70), (80, 2, 64, 9), (64, 1, 200, 2000)])
def test_flash_sdpa_bwd_d64_d80_kernels_match_plain(cuda, dtype, tol, d, h, lq, lk):
    """The dq (and Delta) kernel (the wgmma kernel of flash_sdpa_bwd_dq_h.cu
    in bf16, of flash_sdpa_bwd_dq_h_fp32.cu in fp32; 128-query blocks) and
    the dk/dv kernel (the wgmma kernel of flash_sdpa_bwd_h.cu in bf16, of
    flash_sdpa_bwd_h_fp32.cu in fp32; 128-key blocks) at d=64 and d=80, in
    bf16 and fp32, against the plain backward: the global blocks' shapes
    (fp32: the dq kernel's sums over 4900 and 5184 keys), ragged
    Lq/Lk against the 64-row tiles, a masked 64-key tile, a ragged masked
    tail, a fully masked batch row (zero gradients), dO a strided view of the
    (B, N, H * D) gradient; gradients in (B, N, H, D) memory and the same
    bits when run again. bf16 gradients are sums over thousands of terms in
    other orders: 2e-2 of each gradient's largest magnitude; fp32
    FP32_TOL; Delta 1e-4 (bf16) or FP32_TOL."""
    b = 3
    q, k, v = (_randn(cuda, b, h, n, d, dtype=dtype) for n in (lq, lk, lk))
    bias = _mask_rows(cuda, b, lk)
    o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    do = _randn(cuda, b, lq, h * d, dtype=dtype).reshape(b, lq, h, d).transpose(1, 2)
    scale = d ** -0.5
    bf16 = dtype == torch.bfloat16
    assert fa.bwd_dq_kernel(dtype, d) == ("flash_sdpa_bwd_dq_h" if bf16
                                          else "flash_sdpa_bwd_dq_h_fp32")
    assert fa.bwd_dkv_kernel(dtype, d) == ("flash_sdpa_bwd_h" if bf16 else "flash_sdpa_bwd_h_fp32")
    n_dq, n_dkv = fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert (fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    for g in (dq, dk, dv):
        assert g.transpose(1, 2).is_contiguous()
    dq2, delta2 = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    dk2, dv2 = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    assert all(torch.equal(a, b_) for a, b_ in ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
    want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, bias, do, lse, want_delta, scale)
    dtol = 1e-4 if dtype == torch.bfloat16 else FP32_TOL
    torch.testing.assert_close(delta, want_delta, atol=dtol, rtol=dtol)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel_err(got, want) < tol
        assert (got[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk", [(4, 5184, 5184), (3, 333, 517), (3, 200, 9), (4, 1, 64),
                                     (3, 700, 130)])
def test_flash_sdpa_bwd_dq_h_d32_kernel_matches_plain(cuda, b, lq, lk):
    """The bf16 dq kernel at d=32 (flash_sdpa_bwd_dq_h.cu's d=32
    instantiation: 192-query blocks of three consumer warpgroups, 64-key
    tiles) against the plain dq: the Stage-3 shape (4, 8, 5184, 32), ragged
    Lq and Lk against the block and the tile, a masked 64-key tile in row
    0 (skipped), a ragged masked tail in row 1, a fully masked last batch
    row (no live tile: Delta and zeros), dO a strided view of the (B, N, H
    * D) gradient; Delta within 1e-4, dQ within 2e-2 of its largest
    magnitude, the same bits when run again."""
    q, k, v = (_randn(cuda, b, 8, n, 32) for n in (lq, lk, lk))
    bias = _mask_rows(cuda, b, lk)
    o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    do = _randn(cuda, b, lq, 8 * 32).reshape(b, lq, 8, 32).transpose(1, 2)
    assert lq == 1 or not do.is_contiguous()
    assert fa.bwd_dq_kernel(torch.bfloat16, 32) == "flash_sdpa_bwd_dq_h"
    before = fa.flash_sdpa_bwd_dq.launches
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, 32 ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_sdpa_bwd_dq.launches == before + 1
    assert dq.dtype == torch.bfloat16 and dq.transpose(1, 2).is_contiguous()
    dq2, delta2 = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, 32 ** -0.5)
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, 32 ** -0.5)
    torch.testing.assert_close(delta, want_delta, atol=1e-4, rtol=1e-4)
    assert _rel_err(dq, want_dq) < 2e-2
    assert (dq[-1] == 0).all() and torch.isfinite(dq.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("b,h,lq,lk", [(2, 16, 5184, 5184), (3, 2, 333, 517), (3, 3, 130, 70),
                                       (3, 2, 1, 9), (3, 1, 200, 2000)])
def test_flash_sdpa_bwd_dq_h_kernel_matches_plain(cuda, d, b, h, lq, lk):
    """The bf16 wgmma dq kernel (flash_sdpa_bwd_dq_h.cu, 128-query blocks,
    64-key tiles) against the plain dq in bf16: the teacher's shape, ragged
    Lq and Lk against the block and the tile, a masked 64-key tile in row 0
    (skipped), a ragged masked tail in row 1, a fully masked last batch row
    (no live tile: Delta and zeros, no loads), dO a strided view of the
    (B, N, H * D) gradient; dQ in (B, N, H, D) memory, Delta within 1e-4,
    dQ within 2e-2 of its largest magnitude, the same bits when run again."""
    q, k, v = (_randn(cuda, b, h, n, d) for n in (lq, lk, lk))
    bias = _mask_rows(cuda, b, lk)
    o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    do = _randn(cuda, b, lq, h * d).reshape(b, lq, h, d).transpose(1, 2)
    assert h == 1 or lq == 1 or not do.is_contiguous()
    scale = d ** -0.5
    assert fa.bwd_dq_kernel(torch.bfloat16, d) == "flash_sdpa_bwd_dq_h"
    before = fa.flash_sdpa_bwd_dq.launches
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    torch.cuda.synchronize()
    assert fa.flash_sdpa_bwd_dq.launches == before + 1
    assert dq.dtype == torch.bfloat16 and dq.transpose(1, 2).is_contiguous()
    dq2, delta2 = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
    torch.testing.assert_close(delta, want_delta, atol=1e-4, rtol=1e-4)
    assert dq.shape == want_dq.shape and torch.isfinite(dq.float()).all()
    assert _rel_err(dq, want_dq) < 2e-2
    assert (dq[-1] == 0).all()


# the main path's shape at each head dim: the Stage-3 step (d=32), ViT-H's
# and vit_h's global blocks (d=64, d=80; batch 2 so that a row is masked)
_FP32_FULL = {32: (4, 8, 5184, 5184), 64: (2, 16, 5184, 5184), 80: (2, 16, 4900, 4900)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("shape", ["full", (3, 2, 333, 517), (3, 3, 130, 300), (3, 2, 1, 9),
                                   (3, 1, 2000, 200)], ids=str)
def test_flash_sdpa_bwd_dkv_h_fp32_kernel_matches_plain(cuda, d, shape):
    """The fp32 wgmma dkv kernel (flash_sdpa_bwd_h_fp32.cu, split bf16
    parts, 128-key blocks, 64-query stages, Q and dO from split copies; K
    and V parts in registers at d=32, in shared memory at d=64 and 80)
    against the plain dkv in fp32, given the plain Delta: the main path's
    shape at each head dim ("full": _FP32_FULL), ragged Lq and
    Lk against the block and the stage, a fully masked 128-key block and a
    masked 64-key tile in row 0 (zeros), a ragged masked tail in row 1, a
    fully masked last batch row (zero gradients), dO a strided view of the
    (B, N, H * D) gradient; two launches of the split pass and one of the
    kernel, dK and dV in (B, N, H, D) memory within 1e-4 of each one's
    largest magnitude, the same bits when run again."""
    f32 = torch.float32
    b, h, lq, lk = _FP32_FULL[d] if shape == "full" else shape
    q, k, v = (_randn(cuda, b, h, n, d, dtype=f32) for n in (lq, lk, lk))
    bias = _mask_rows(cuda, b, lk)
    bias[0, 128:256] = NEG_INF
    o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    do = _randn(cuda, b, lq, h * d, dtype=f32).reshape(b, lq, h, d).transpose(1, 2)
    scale = d ** -0.5
    _, delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
    assert fa.bwd_dkv_kernel(f32, d) == "flash_sdpa_bwd_h_fp32"
    n_split, n_dkv = fa.split_parts.launches, fa.flash_sdpa_bwd_dkv.launches
    dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert (fa.split_parts.launches, fa.flash_sdpa_bwd_dkv.launches) == (n_split + 2, n_dkv + 1)
    dk2, dv2 = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, bias, do, lse, delta, scale)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert got.dtype == f32 and got.shape == want.shape and torch.isfinite(got).all()
        assert got.transpose(1, 2).is_contiguous()
        assert _rel_err(got, want) < FP32_TOL
        assert (got[-1] == 0).all() and (got[0, :, 64:min(lk, 256)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("shape", ["full", "all_live", (3, 2, 333, 517), (3, 3, 130, 70),
                                   (3, 2, 1, 9), (3, 1, 200, 2000)], ids=str)
def test_flash_sdpa_bwd_dq_h_fp32_kernel_matches_plain(cuda, d, shape):
    """The fp32 wgmma dq kernel (flash_sdpa_bwd_dq_h_fp32.cu, split bf16
    parts, 128-query blocks, 64-key tiles from the split copies of K and V)
    against the plain dq in fp32: the main path's shape at each head dim
    ("full": _FP32_FULL); "all_live" 333 queries against the full key count
    with every key live, where a dQ summed in the tensor cores' truncating
    fp32 adds over the whole row would carry its bias (the kernel adds its
    fragment into the row's sum with round-to-nearest adds every few
    tiles); ragged Lq and Lk against the block and the tile, a masked
    64-key tile in row 0 (skipped), a ragged masked tail in row 1, a fully
    masked last batch row (no live tile: Delta and zeros, no loads), dO a
    strided view of the (B, N, H * D) gradient; two launches of the split
    pass and one of the kernel, dQ in (B, N, H, D) memory within 1e-4 of
    its largest magnitude, Delta within 1e-4, the same bits when run
    again."""
    f32 = torch.float32
    if shape == "all_live":
        b, h, _, lk = _FP32_FULL[d]
        b, lq = 1, 333
    else:
        b, h, lq, lk = _FP32_FULL[d] if shape == "full" else shape
    q, k, v = (_randn(cuda, b, h, n, d, dtype=f32) for n in (lq, lk, lk))
    bias = torch.zeros((b, lk), device=cuda) if shape == "all_live" else _mask_rows(cuda, b, lk)
    o, lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    do = _randn(cuda, b, lq, h * d, dtype=f32).reshape(b, lq, h, d).transpose(1, 2)
    assert h == 1 or lq == 1 or not do.is_contiguous()
    scale = d ** -0.5
    assert fa.bwd_dq_kernel(f32, d) == "flash_sdpa_bwd_dq_h_fp32"
    n_split, n_dq = fa.split_parts.launches, fa.flash_sdpa_bwd_dq.launches
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (fa.split_parts.launches, fa.flash_sdpa_bwd_dq.launches) == (n_split + 2, n_dq + 1)
    assert dq.dtype == f32 and dq.transpose(1, 2).is_contiguous()
    dq2, delta2 = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
    torch.testing.assert_close(delta, want_delta, atol=FP32_TOL, rtol=FP32_TOL)
    assert dq.shape == want_dq.shape and torch.isfinite(dq).all()
    assert _rel_err(dq, want_dq) < FP32_TOL
    if shape != "all_live":
        assert (dq[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80])
def test_vit_trunk_training_step_on_card_matches_cpu(cuda, d):
    """A ViT trunk of 2 heads of d in training mode (drop path 0, blocks
    checkpointed) whose 46x46 token grid (644^2 at patch 14) sends its one
    global block through flash_sdpa (2116^2 scores), one Stage-1 step in
    fp32 on the card against the same step on the CPU: flash_sdpa 2
    launches (the forward and its recompute), dq and dkv 1 each; the loss
    within 1e-5 relative and every gradient within 1e-4 of its largest
    magnitude."""
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
    from efficientsam3_tpu_torch.train import stage1

    torch.backends.cudnn.allow_tf32 = False  # the patch embedding in fp32

    def trunk():
        return ViTTrunk(embed_dim=2 * d, depth=2, num_heads=2, window_size=23,
                        global_att_blocks=(1,), pretrain_grid=23, drop_path_rate=0.0)

    ref = init_parameters(trunk(), 2)
    model = trunk().to(cuda)
    model.load_state_dict(ref.state_dict())
    batch = {"image": RNG.standard_normal((1, 644, 644, 3)).astype(np.float32),
             "teacher": RNG.standard_normal((1, 46, 46, 2 * d)).astype(np.float32),
             "valid": np.ones((1, 46, 46), np.float32)}
    out = {}
    for name, m in (("cpu", ref), ("cuda", model)):
        opt = stage1.make_optimizer(stage1.Stage1ImageConfig(), 10, m)
        counts = (fa.flash_sdpa.launches, fa.flash_sdpa_bwd_dq.launches,
                  fa.flash_sdpa_bwd_dkv.launches)
        grads = {}
        step_ = opt.step

        def keep_grads(m=m, step_=step_, grads=grads):  # before the in-place clip
            grads.update({k: p.grad.detach().float().cpu().clone()
                          for k, p in m.named_parameters()})
            step_()

        opt.step = keep_grads
        loss = float(stage1.stage1_train_step(m, opt, batch)["loss"])
        torch.cuda.synchronize()
        launched = tuple(n - c for n, c in zip((fa.flash_sdpa.launches,
                                                fa.flash_sdpa_bwd_dq.launches,
                                                fa.flash_sdpa_bwd_dkv.launches), counts))
        assert launched == ((2, 1, 1) if name == "cuda" else (0, 0, 0)), launched
        out[name] = (loss, grads)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        assert (got - want).abs().max() <= 1e-4 * want.abs().max().clamp_min(1e-30), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_tiny_vit_student_on_card_matches_cpu(cuda, dtype):
    """A SAM1 student over a ViT trunk of 2 heads of 80 whose 46x46 token
    grid (736^2, window 23) sends its one global block through flash_sdpa
    at d=80 (2116^2 scores, above sdpa's threshold), on the card against
    the same model in fp32 on the CPU: the embedding and a point prompt's
    low-res masks and IoUs, fp32 within 1e-3 of each output's largest
    magnitude (at least 1), bf16 within 1e-1 (bf16 through the trunk, the
    two-way transformer and the upscaler)."""
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
    from efficientsam3_tpu_torch.student_sam import SamStudentModel

    torch.backends.cudnn.allow_tf32 = False  # the neck's convolutions in fp32

    def tiny(dt):
        trunk = ViTTrunk(patch_size=16, embed_dim=160, depth=2, num_heads=2, window_size=23,
                         global_att_blocks=(1,), pretrain_grid=16, mlp_ratio=4.0, dtype=dt)
        return SamStudentModel(trunk, image_size=736, embed_size=16, dtype=dt).eval()

    ref_model = init_parameters(tiny(None), 1)
    model = tiny(dtype).to(cuda)
    model.load_state_dict(ref_model.state_dict())
    img = torch.from_numpy(RNG.standard_normal((1, 736, 736, 3)).astype(np.float32))
    pts = torch.tensor([[[300.0, 200.0], [0.0, 0.0]]])
    labs = torch.tensor([[1, -1]])
    with torch.inference_mode():
        ref_emb = ref_model.encode_image(img)
        ref = ref_model.predict_masks(ref_emb, pts, labs, True)
        before = fa.flash_sdpa.launches
        emb = model.encode_image(img.to(cuda))
        torch.cuda.synchronize()
        assert fa.flash_sdpa.launches == before + 1
        got = model.predict_masks(emb, pts.to(cuda), labs.to(cuda), True)
    tol = 1e-3 if dtype == torch.float32 else 1e-1
    for g, w in ((emb, ref_emb), *zip(got, ref)):
        err = (g.float().cpu() - w.float()).abs().max().item()
        assert err <= tol * max(1.0, w.abs().max().item()), err


# -------------------------------------------------------------------------
# the bf16 forward at d=256 (flash_sdpa_h.cu) and the fp32 forward at d=32,
# 64 and 80 (flash_sdpa_h_fp32.cu, split bf16 parts): the wgmma kernels
# that replaced the mma.sync ones


def _strided_qkv(dev, b, h, lq, lk, d, dtype, slab_scale=None):
    """q a split_heads view of a (B, Lq, H * D) map, k and v views of one
    packed (B, Lk, 2, H, D) tensor: strides over (B, H, N), D contiguous.
    slab_scale (D,) multiplies every row before the cast."""
    def draw(*shape):
        x = _randn(dev, *shape, dtype=torch.float32)
        return (x if slab_scale is None else x * slab_scale).to(dtype)

    q = draw(b, lq, h, d).transpose(1, 2)
    k, v = draw(b, lk, 2, h, d).permute(2, 0, 3, 1, 4)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["self", "cross", "ragged", "strided", "one_row"])
def test_flash_sdpa_h_d256_cases_match_plain(cuda, case):
    """bf16 at d=256 (the wgmma kernel of flash_sdpa_h.cu: 128-query
    blocks, rows as four 64-column slabs, V MN-major across them) against
    the plain version. self: the tracked frame's self-attention, (8, 1,
    5184, 256) with 3 of 8 slots live (5 batch rows fully masked: zeros,
    lse -1e9, no loads); cross: the plain path's cross-attention at 333
    queries over 36352 keys, 3 of 8 slots live, each live slot's last 37
    keys masked (a ragged tile); ragged: Lq 333 and Lk 517, a masked 64-key
    tile (skipped), a ragged masked tail, a fully masked last row; strided:
    q, k and v views of separate and packed tensors over 2 heads, each
    64-column slab at its own scale (a slab read through a wrong descriptor
    shows against its own largest magnitude); one_row: Lq 1, Lk 64. The
    output within 2e-2 of the largest magnitude, each slab on its own, the
    LSE within 1e-2, the same bits when run again."""
    b, h, lq, lk = {"self": (8, 1, 5184, 5184), "cross": (8, 1, 333, 36352),
                    "ragged": (3, 1, 333, 517), "strided": (2, 2, 700, 900),
                    "one_row": (2, 1, 1, 64)}[case]
    scale = None
    if case == "strided":
        scale = torch.tensor([1.0, 0.25, 3.0, 0.5], device=cuda).repeat_interleave(64)
    q, k, v = _strided_qkv(cuda, b, h, lq, lk, 256, torch.bfloat16, scale)
    if case in ("self", "cross"):
        bias = torch.full((b, lk), NEG_INF, device=cuda)
        bias[:3] = 0.0
        if case == "cross":
            bias[:3, lk - 37:] = NEG_INF
    else:
        bias = _mask_rows(cuda, b, lk)
    assert fa.sdpa_kernel(torch.bfloat16, 256) == "flash_sdpa_h"
    before = fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_sdpa.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.transpose(1, 2).is_contiguous()
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    for j in range(4):
        assert _rel_err(got[..., 64 * j:64 * j + 64], want[..., 64 * j:64 * j + 64]) < 2e-2, j
    torch.testing.assert_close(lse, want_lse, atol=1e-2, rtol=1e-2)
    dead = (bias <= NEG_INF / 2).all(-1)
    assert dead.any() and (got[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    assert torch.equal(fa.flash_sdpa(q, k, v, bias), got)


# the main path's fp32 forward shapes: the `ground` (d=32), the teacher's
# (d=64) and vit_h's (d=80) global blocks at batch 1, every key live
_FWD_F32_FULL = {32: (1, 8, 5184, 5184), 64: (1, 16, 5184, 5184), 80: (1, 16, 4900, 4900)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("shape", ["full", (3, 2, 333, 517), (3, 3, 130, 70), (3, 2, 1, 9),
                                   (3, 1, 200, 2000)], ids=str)
def test_flash_sdpa_h_fp32_kernel_matches_plain(cuda, d, shape):
    """The fp32 wgmma forward (flash_sdpa_h_fp32.cu: split bf16 parts,
    128-query blocks, 64-key tiles from the split copies of K and V)
    against the plain version in fp32: the main path's shape at each head
    dim with every key live ("full": _FWD_F32_FULL; an O summed in the
    tensor cores' truncating fp32 adds over the whole row would carry
    their bias, so each tile's P V starts a fresh fragment added by
    round-to-nearest FMAs); ragged Lq and Lk against the block and the
    tile, masked 64-key tiles in row 0 (skipped), a ragged masked tail in
    row 1, a fully masked last row (0, lse -1e9); q, k and v strided views;
    two launches of the split pass and one of the kernel, the output in
    (B, N, H, D) memory and the LSE within 1e-4, the same bits when run
    again."""
    f32 = torch.float32
    b, h, lq, lk = _FWD_F32_FULL[d] if shape == "full" else shape
    q, k, v = _strided_qkv(cuda, b, h, lq, lk, d, f32)
    if shape == "full":
        bias = torch.zeros((b, lk), device=cuda)
    else:
        bias = _mask_rows(cuda, b, lk)
        bias[0, 128:256] = NEG_INF
    assert fa.sdpa_kernel(f32, d) == "flash_sdpa_h_fp32"
    n_split, n_fwd = fa.split_parts.launches, fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert (fa.split_parts.launches, fa.flash_sdpa.launches) == (n_split + 2, n_fwd + 1)
    assert got.dtype == f32 and got.transpose(1, 2).is_contiguous()
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, atol=FP32_TOL, rtol=FP32_TOL)
    if shape != "full":
        assert (got[-1] == 0).all() and (lse[-1] == NEG_INF).all()
    assert torch.equal(fa.flash_sdpa(q, k, v, bias), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256), (torch.float32, 32),
                                     (torch.float32, 64), (torch.float32, 80)],
                         ids=["bf16-256", "fp32-32", "fp32-64", "fp32-80"])
def test_new_forwards_feed_the_backward_kernels(cuda, dtype, d):
    """The new forwards under autograd, so that the backward kernels read
    their LSE (bf16 d=256: flash_sdpa_bwd_wide_h.cu; fp32:
    flash_sdpa_bwd_dq_h_fp32.cu and flash_sdpa_bwd_h_fp32.cu): one launch of
    the forward, dq and dkv kernels each, gradients against autograd through
    the plain forward within 3e-2 (bf16) or 1e-4 (fp32) of each one's
    largest magnitude, a masked tile, a ragged masked tail and a fully
    masked row; key_bias gets a zero gradient."""
    h = 1 if d == 256 else 2
    q, k, v = _strided_qkv(cuda, 2, h, 600, 900, d, dtype)
    bias = _mask_rows(cuda, 2, 900)
    w = _randn(cuda, 2, h, 600, d, dtype=torch.float32)
    wrappers = (fa.flash_sdpa, fa.flash_sdpa_bwd_dq, fa.flash_sdpa_bwd_dkv)
    grads = {}
    for name, fn in (("kernel", fa.flash_sdpa), ("plain", fa.flash_sdpa_plain)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        before = [f.launches for f in wrappers]
        (fn(*leaves).float() * w).sum().backward()
        torch.cuda.synchronize()
        launched = [f.launches - n for f, n in zip(wrappers, before)]
        assert launched == ([1, 1, 1] if name == "kernel" else [0, 0, 0]), launched
        grads[name] = [t.grad for t in leaves]
    tol = 3e-2 if dtype == torch.bfloat16 else FP32_TOL
    for got, want in zip(grads["kernel"][:3], grads["plain"][:3]):
        assert got.dtype == dtype and _rel_err(got, want) < tol
    assert (grads["kernel"][3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.float32, 128),
                                     (torch.float16, 32)], ids=["bf16-128", "fp32-128", "fp16-32"])
def test_large_attention_the_kernels_do_not_take_runs_on_the_card(cuda, dtype, d):
    """A large attention (2048 x 2048 scores) at a head dim or dtype no
    kernel takes, where JAX's Pallas kernel runs: models/common.sdpa on the
    card takes the matmul path (not flash_eligible, no flash_sdpa launch)
    instead of raising, and matches the same attention in fp32 on the CPU
    (1e-4 in fp32, 2e-2 of the largest magnitude in 16-bit types)."""
    from efficientsam3_tpu_torch.models import common

    q, k, v = (_randn(cuda, 2, 2, 2048, d, dtype=dtype) for _ in range(3))
    mask = torch.ones((2, 1, 1, 2048), dtype=torch.bool, device=cuda)
    mask[0, ..., 1500:] = False
    mask[1, ..., :64] = False
    assert not common.flash_eligible(q.shape, k.shape, v.shape, (dtype,) * 3, mask.shape)
    before = fa.flash_sdpa.launches
    got = common.sdpa(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert fa.flash_sdpa.launches == before and got.dtype == dtype
    want = common.sdpa(*(t.float().cpu() for t in (q, k, v)), mask=mask.cpu())
    assert _rel_err(got.cpu(), want) < (1e-4 if dtype == torch.float32 else 2e-2)


# -------------------------------------------------------------------------
# the tracker's bank attention (flash_memattn_h.cu, bf16 and fp32) and the
# fp32 forward at d=256 (flash_sdpa_h_fp32.cu's d=256 kernel): the wgmma
# kernels that replaced the mma.sync kernel of the former flash_qsmem.cuh

_S_E, _N_MEM, _BANK = 5184, 7, 36864  # an entry's keys, entries, the padded bank


def _bank_bias(dev, live_slots, entries, slots=8):
    """The cached tracker's key bias over the padded bank: the first
    ``live_slots`` of ``slots`` hold ``entries`` valid entries of 5184 keys
    each, the rest of each row (invalid entries, the 576-key pad tail) and
    every other slot masked."""
    bias = torch.full((slots, _BANK), NEG_INF, device=dev)
    bias[:live_slots, :entries * _S_E] = 0.0
    return bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", ["slots1", "slots3", "slots8", "entry", "ragged", "strided",
                                  "one_row"])
def test_flash_memattn_h_cases_match_plain(cuda, dtype, case):
    """The bank kernel of flash_memattn_h.cu (dk 256, raw dv 64 values; bf16,
    and fp32 on split parts read from two split passes that skip dead
    32-key tiles) against the plain version. slotsN: the tracker's shape, q
    (8, 1, 5184, 256) over the padded 36864-key bank with N of 8 slots
    live, every entry valid (the 576-key pad tail masked), the other slots
    empty (zeros, lse -1e9, no loads); entry: 3 live slots with one valid
    entry and one masked in the middle (its tiles skipped); ragged: Lq 333
    and Lk 517, a masked entry and a ragged pad tail in row 0, an empty
    slot; strided: the per-layer bank views, keys a layer of a (L, B, S,
    256) bank and values a column slice of a wider tensor (batch and row
    strides not those of a contiguous tensor); one_row: Lq 1, Lk 64. The
    output within 2e-2 (bf16) or 1e-4 (fp32) of its largest magnitude, the
    LSE within 1e-2 / 1e-4, the same bits with and without the LSE, one
    launch of the kernel (and two of the split pass in fp32)."""
    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    b, lq, lk = {"ragged": (3, 333, 517), "strided": (3, 700, 1100),
                 "one_row": (2, 1, 64)}.get(case, (8, 5184, _BANK))
    q = _randn(cuda, b, 1, lq, 256, dtype=dtype)
    if case == "strided":
        k = _randn(cuda, 2, b, lk + 64, 256, dtype=dtype)[1, :, :lk][:, None]
        v = _randn(cuda, b, lk, 128, dtype=dtype)[..., 32:96][:, None]
        assert not k.is_contiguous() and not v.is_contiguous()
    else:
        k = _randn(cuda, b, 1, lk, 256, dtype=dtype)
        v = _randn(cuda, b, lk, 64, dtype=dtype)[:, None]
    if case.startswith("slots"):
        bias = _bank_bias(cuda, int(case[5:]), _N_MEM)
    elif case == "entry":
        bias = _bank_bias(cuda, 3, 3)
        bias[:, _S_E:2 * _S_E] = NEG_INF
    else:
        bias = torch.zeros((b, lk), device=cuda)
        bias[0, lk // 4: lk // 2] = NEG_INF
        bias[0, lk - lk // 8:] = NEG_INF
        bias[-1] = NEG_INF
    assert fa.memattn_kernel(dtype) == ("flash_memattn_h" if dtype == torch.bfloat16
                                        else "flash_memattn_h_fp32")
    before = (fa.flash_memattn.launches, fa.split_parts.launches)
    got, lse = fa.flash_memattn(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert (fa.flash_memattn.launches, fa.split_parts.launches) == (
        before[0] + 1, before[1] + (2 if dtype == torch.float32 else 0))
    assert got.dtype == dtype and got.shape == (b, 1, lq, 64)
    want, want_lse = fa.flash_memattn_plain(q, k, v, bias, return_lse=True)
    assert _rel_err(got, want) < tol
    lse_tol = 1e-2 if dtype == torch.bfloat16 else FP32_TOL
    torch.testing.assert_close(lse, want_lse, atol=lse_tol, rtol=lse_tol)
    dead = (bias <= NEG_INF / 2).all(-1)
    assert dead.any() == (case != "slots8")  # every slot live at 8
    assert (got[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    assert torch.equal(fa.flash_memattn(q, k, v, bias), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", ["slots1", "slots3", "slots8", "entry", "ragged", "strided",
                                  "one_row"])
def test_flash_memattn_q8_h_cases_match_plain(cuda, dtype, case):
    """The int8 bank kernel (flash_memattn_h.cu's int8-key instantiation:
    q quantized in the prologue, int8 wgmma for Q K^T; fp32 P V on split
    parts of v from one split pass that skips dead 64-key tiles) against
    the plain version. slotsN: the tracker's shape, q (8, 1, 5184, 256) over
    the padded 36864-key int8 bank with N of 8 slots live, every entry
    valid (the 576-key pad tail masked), the other slots empty (zeros, lse
    -1e9, no loads); entry: 3 live slots with one valid entry and one
    masked in the middle (its tiles skipped); ragged: Lq 333 over 640 keys,
    a masked entry and a pad tail in row 0, an empty slot; strided: the
    per-layer bank views, the int8 keys a layer of a (L, B, S, 256) bank and
    the values a column slice of a wider tensor; one_row: Lq 1, Lk 128. The
    output within 2e-2 (bf16) or 1e-4 (fp32) of its largest magnitude, the
    LSE within 1e-2 / 1e-4, the same bits with and without the LSE, one
    launch of the kernel (and one of the split pass in fp32)."""
    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    b, lq, lk = {"ragged": (3, 333, 640), "strided": (3, 700, 1152),
                 "one_row": (2, 1, 128)}.get(case, (8, 5184, _BANK))
    q = _randn(cuda, b, 1, lq, 256, dtype=dtype)
    if case == "strided":
        k_i8, ks = fa.quantize_rows(_randn(cuda, 2, b, lk + 64, 256, dtype=dtype))
        k_i8, ks = k_i8[1, :, :lk][:, None], ks[1, :, :lk, 0]
        v = _randn(cuda, b, lk, 128, dtype=dtype)[..., 32:96][:, None]
        assert not k_i8.is_contiguous() and not v.is_contiguous()
    else:
        k_i8, ks = fa.quantize_rows(_randn(cuda, b, 1, lk, 256, dtype=dtype))
        ks = ks[:, 0, :, 0]
        v = _randn(cuda, b, lk, 64, dtype=dtype)[:, None]
    if case.startswith("slots"):
        bias = _bank_bias(cuda, int(case[5:]), _N_MEM)
    elif case == "entry":
        bias = _bank_bias(cuda, 3, 3)
        bias[:, _S_E:2 * _S_E] = NEG_INF
    else:
        bias = torch.zeros((b, lk), device=cuda)
        bias[0, lk // 4: lk // 2] = NEG_INF
        bias[0, lk - lk // 8:] = NEG_INF
        bias[-1] = NEG_INF
    before = (fa.flash_memattn_q8.launches, fa.split_parts.launches)
    got, lse = fa.flash_memattn_q8(q, k_i8, ks, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert (fa.flash_memattn_q8.launches, fa.split_parts.launches) == (
        before[0] + 1, before[1] + (1 if dtype == torch.float32 else 0))
    assert got.dtype == dtype and got.shape == (b, 1, lq, 64)
    want, want_lse = fa.flash_memattn_q8_plain(q, k_i8, ks, v, bias, return_lse=True)
    assert _rel_err(got, want) < tol
    lse_tol = 1e-2 if dtype == torch.bfloat16 else FP32_TOL
    torch.testing.assert_close(lse, want_lse, atol=lse_tol, rtol=lse_tol)
    dead = (bias <= NEG_INF / 2).all(-1)
    assert dead.any() == (case != "slots8")  # every slot live at 8
    assert (got[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    assert torch.equal(fa.flash_memattn_q8(q, k_i8, ks, v, bias), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["self", "cross", "ragged", "strided", "one_row"])
def test_flash_sdpa_h_fp32_d256_cases_match_plain(cuda, case):
    """fp32 at d=256 (flash_sdpa_h_fp32.cu's d=256 kernel: 64-query blocks,
    two consumer warpgroups each computing S and half of the output
    columns, 32-key tiles from split copies that skip dead tiles) against
    the plain version. self: the tracked frame's self-attention, (8, 1,
    5184, 256) with 3 of 8 slots live; cross: the training clip's plain
    cross-attention, 5184 queries over 36352 keys, 3 of 8 slots live, each
    live slot's last 37 keys masked (a ragged tile; O sums over ~36300
    keys, where the tensor cores' truncating adds would show); ragged: Lq
    333 and Lk 517, a masked tile, a ragged masked tail, a fully masked
    row; strided: q, k and v views over 2 heads, each 64-column slab at its
    own scale; one_row: Lq 1, Lk 64. The output within 1e-4, each slab on
    its own and against its own largest magnitude, the LSE within 1e-4,
    the same bits when run again; two split passes and one launch."""
    b, h, lq, lk = {"self": (8, 1, 5184, 5184), "cross": (8, 1, 5184, 36352),
                    "ragged": (3, 1, 333, 517), "strided": (2, 2, 700, 900),
                    "one_row": (2, 1, 1, 64)}[case]
    scale = None
    if case == "strided":
        scale = torch.tensor([1.0, 0.25, 3.0, 0.5], device=cuda).repeat_interleave(64)
    q, k, v = _strided_qkv(cuda, b, h, lq, lk, 256, torch.float32, scale)
    if case in ("self", "cross"):
        bias = torch.full((b, lk), NEG_INF, device=cuda)
        bias[:3] = 0.0
        if case == "cross":
            bias[:3, lk - 37:] = NEG_INF
    else:
        bias = _mask_rows(cuda, b, lk)
    assert fa.sdpa_kernel(torch.float32, 256) == "flash_sdpa_h_fp32"
    n_split, n_fwd = fa.split_parts.launches, fa.flash_sdpa.launches
    got, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert (fa.split_parts.launches, fa.flash_sdpa.launches) == (n_split + 2, n_fwd + 1)
    assert got.dtype == torch.float32 and got.transpose(1, 2).is_contiguous()
    want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, return_lse=True)
    for j in range(4):
        assert _rel_err(got[..., 64 * j:64 * j + 64], want[..., 64 * j:64 * j + 64]) < FP32_TOL, j
    torch.testing.assert_close(lse, want_lse, atol=FP32_TOL, rtol=FP32_TOL)
    dead = (bias <= NEG_INF / 2).all(-1)
    assert dead.any() and (got[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    del want, want_lse
    assert torch.equal(fa.flash_sdpa(q, k, v, bias), got)


# ---- flash_xattn_rpb on wgmma + TMA, its key splits merged in a cluster,
# and layer_norm's CUDA forward


def _xattn_inputs(dev, b, lq, hw, dtype, strided=False):
    """The decoder's cross-attention operands: q, k, v (B, 8, n, 32) (with
    strided, split_heads views of (B, n, 256) projections, as the decoder
    hands them in), ey / ex f32 at the scale of its boxRPB bias."""
    h, d = 8, 32
    lk = hw[0] * hw[1]
    if strided:
        q, k, v = (_randn(dev, b, n, h * d, dtype=dtype).view(b, n, h, d).transpose(1, 2)
                   for n in (lq, lk, lk))
    else:
        q, k, v = (_randn(dev, b, h, n, d, dtype=dtype) for n in (lq, lk, lk))
    ey = 2.0 * _randn(dev, b, h, lq, hw[0], dtype=torch.float32)
    ex = 2.0 * _randn(dev, b, h, lq, hw[1], dtype=torch.float32)
    return q, k, v, ey, ex


XATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: FP32_TOL}  # of the largest magnitude


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_flash_xattn_rpb_every_cluster_size_matches_plain(cuda, dtype, splits):
    """The decoder's shape (201 queries over a 72 x 72 map) at every key
    split count the rule can pick (each the cluster size): within 2e-2
    (bf16) or 1e-4 (fp32) of the plain version's largest magnitude, one
    kernel launch a call (fp32: and the two split passes), and the same
    bits when run again (the merge sums the splits in a fixed order)."""
    q, k, v, ey, ex = _xattn_inputs(cuda, 1, 201, (72, 72), dtype, strided=True)
    n_call, n_split = fa.flash_xattn_rpb.launches, fa.split_parts.launches
    got = fa.flash_xattn_rpb(q, k, v, ey, ex, (72, 72), splits=splits)
    torch.cuda.synchronize()
    assert fa.flash_xattn_rpb.launches == n_call + 1
    assert fa.split_parts.launches == n_split + (2 if dtype == torch.float32 else 0)
    assert got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    assert _rel_err(got, fa.flash_xattn_rpb_plain(q, k, v, ey, ex, (72, 72))) < XATTN_TOL[dtype]
    assert torch.equal(fa.flash_xattn_rpb(q, k, v, ey, ex, (72, 72), splits=splits), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,lq,hw", [(1, 201, (72, 72)), (2, 201, (72, 72)), (1, 65, (5, 7)),
                                     (3, 1, (5, 7)), (1, 201, (127, 127)), (2, 130, (127, 127)),
                                     (1, 7, (3, 5)), (1, 201, (1, 100))])
def test_flash_xattn_rpb_maps_match_plain(cuda, dtype, b, lq, hw):
    """Maps of 5 x 7, 127 x 127 (16129 keys: the stages a ring) and others,
    ragged query tiles, at the splits the rule picks."""
    q, k, v, ey, ex = _xattn_inputs(cuda, b, lq, hw, dtype)
    got = fa.flash_xattn_rpb(q, k, v, ey, ex, hw)
    torch.cuda.synchronize()
    assert _rel_err(got, fa.flash_xattn_rpb_plain(q, k, v, ey, ex, hw)) < XATTN_TOL[dtype]


@pytest.mark.cuda
def test_flash_xattn_rpb_refuses_split_counts(cuda):
    q, k, v, ey, ex = _xattn_inputs(cuda, 1, 9, (3, 5), torch.bfloat16)
    for splits in (0, 2, 9):  # 15 keys are one tile
        with pytest.raises(ValueError, match="splits"):
            fa.flash_xattn_rpb(q, k, v, ey, ex, (3, 5), splits=splits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_flash_xattn_rpb_fits_one_wave(cuda, dtype):
    """The design's occupancy at the decoder's shape: no spills, two
    blocks an SM (the stages sized to fit), the rule's splits leaving every
    cluster of the grid (4 query tiles x 8 heads) resident at once: one
    wave."""
    splits = fa.xattn_splits_for(dtype, 8, 201, (72, 72))
    res = fa.xattn_resources(dtype, (72, 72), splits)
    per_sm = 2
    assert res["spill_bytes"] == 0 and res["blocks_per_sm"] == per_sm, res
    assert res["max_clusters"] >= 32 and res["stages"] >= 2, res
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert splits * 32 <= per_sm * sms and splits >= 2, (splits, res)
    assert fa.xattn_resources(dtype, (127, 127), 8)["blocks_per_sm"] == per_sm


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,out_dtype", LN_DTYPES)
@pytest.mark.parametrize("c", LN_CHANNELS)
def test_layer_norm_autograd_dtypes_match_plain_autograd(cuda, x_dtype, out_dtype, c):
    """Under autograd: the CUDA forward and backward, one launch each,
    against autograd of the plain version."""
    x = (3.0 * _randn(cuda, 2, 201, c, dtype=x_dtype)).requires_grad_()
    w = (1.0 + 0.1 * _randn(cuda, c, dtype=torch.float32)).requires_grad_()
    b = (0.1 * _randn(cuda, c, dtype=torch.float32)).requires_grad_()
    g = _randn(cuda, 2, 201, c, dtype=torch.float32)
    fwd, bwd = ln.layer_norm.launches, ln.layer_norm_bwd.launches
    y = ln.layer_norm(x, w, b, 1e-5, out_dtype)
    got = torch.autograd.grad((y.float() * g).sum(), (x, w, b))
    assert (ln.layer_norm.launches, ln.layer_norm_bwd.launches) == (fwd + 1, bwd + 1)
    y_plain = ln.layer_norm_plain(x, w, b, 1e-5, out_dtype)
    torch.testing.assert_close(y.float(), y_plain.float(), atol=TOL, rtol=TOL)
    want = torch.autograd.grad((y_plain.float() * g).sum(), (x, w, b))
    for a, e in zip(got, want):
        assert _rel_err(a, e) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,out_dtype", LN_DTYPES)
def test_layer_norm_reads_unaligned_and_strided_rows(cuda, x_dtype, out_dtype):
    """Rows of a strided view (row stride 264: the vector path), of an
    unaligned one (stride 257, the base one element in: the masked path),
    of channel-major maps seen as (1, N, C) (the fusion encoder's tokens:
    the column path, at 256 and 250 channels, 5184 and 201 rows, and 600
    channels: the masked path with strided columns) and of a batch of two
    such maps (its axes do not merge: a copy first)."""
    for c, make in ((256, lambda: (3.0 * _randn(cuda, 300, 264, dtype=x_dtype))[:, 8:264]),
                    (256, lambda: (3.0 * _randn(cuda, 300, 257, dtype=x_dtype))[:, 1:257]),
                    (256, lambda: (3.0 * _randn(cuda, 1, 256, 5184, dtype=x_dtype)).transpose(1, 2)),
                    (250, lambda: (3.0 * _randn(cuda, 1, 250, 201, dtype=x_dtype)).transpose(1, 2)),
                    (600, lambda: (3.0 * _randn(cuda, 1, 600, 77, dtype=x_dtype)).transpose(1, 2)),
                    (256, lambda: (3.0 * _randn(cuda, 2, 256, 999, dtype=x_dtype)).transpose(1, 2))):
        x = make()
        w = 1.0 + 0.1 * _randn(cuda, c, dtype=torch.float32)
        b = 0.1 * _randn(cuda, c, dtype=torch.float32)
        before = ln.layer_norm.launches
        got = ln.layer_norm(x, w, b, 1e-5, out_dtype)
        assert ln.layer_norm.launches == before + 1 and got.shape == x.shape
        want = ln.layer_norm_plain(x, w, b, 1e-5, out_dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,out_dtype", LN_DTYPES)
def test_layer_norm_kernel_fits_without_spills(cuda, x_dtype, out_dtype):
    """At 256 contiguous channels the vector path: one 16-byte load a lane
    in bf16, two in fp32, no spills; 250 channels the masked path; 256
    channels 5184 elements apart (a channel-major map) the column path."""
    res = ln.kernel_resources(x_dtype, out_dtype, 256)
    assert res["spill_bytes"] == 0 and res["path"] == (1 if x_dtype == torch.bfloat16 else 2)
    assert res["blocks_per_sm"] >= 4, res
    assert ln.kernel_resources(x_dtype, out_dtype, 250)["path"] == 0
    res = ln.kernel_resources(x_dtype, out_dtype, 256, col_stride=5184)
    assert res["path"] == -1 and res["spill_bytes"] == 0 and res["blocks_per_sm"] >= 4, res


# ---- the 7x7 depthwise conv redesigned (a walk of persistent blocks down
# the map's rows; one backward kernel for dx, dw and db) and layer_norm's
# backward in CUDA


def _kernels_of(fn):
    """The device kernels one fn() call launches, by name (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: first-use allocations (the tickets) out of the count
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


DW_CARD_SHAPES = [(8, 72, 72, 256), (2, 13, 29, 40), (1, 9, 5, 37), (3, 11, 40, 33),
                  (1, 7, 7, 8), (2, 20, 75, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", DW_CARD_SHAPES, ids=str)
def test_depthwise_kernels_same_bits_one_launch(cuda, dtype, shape):
    """The forward and the backward kernel at the tracker shape, ragged H,
    W and C (element staging at 37 and 33 channels, two and three strips at
    W = 40 and 75), the taps and bias as CXBlock hands them (a permuted view
    of a (C, 1, 7, 7) weight, in the maps' dtype): within 1e-2 (bf16) or
    1e-4 (fp32) of the plain versions' largest magnitude, dw / db within
    1e-5 of fp64 sums; one launch a call; the same bits when run again (the
    partials finished in a fixed order); the tickets left at 0."""
    c = shape[-1]
    x = _randn(cuda, *shape, dtype=dtype)
    g = (1e-2 * _randn(cuda, *shape, dtype=torch.float32)).to(dtype)
    wk = (0.2 * _randn(cuda, c, 1, 7, 7, dtype=torch.float32)).to(dtype).permute(2, 3, 1, 0)
    bias = (0.1 * _randn(cuda, c, dtype=torch.float32)).to(dtype)
    fwd, bwd = dw.depthwise_conv2d.launches, dw.depthwise_conv2d_bwd.launches
    got = dw.depthwise_conv2d(x, wk, bias)
    dx, dwt, db = dw.depthwise_conv2d_bwd(x, wk, g)
    torch.cuda.synchronize()
    assert (dw.depthwise_conv2d.launches, dw.depthwise_conv2d_bwd.launches) == (fwd + 1, bwd + 1)
    assert got.dtype == dx.dtype == dtype and dwt.dtype == db.dtype == torch.float32
    tol = TOL if dtype == torch.bfloat16 else FP32_TOL
    assert _rel_err(got, dw.depthwise_conv2d_plain(x, wk, bias)) < tol
    assert _rel_err(dx, dw.depthwise_conv2d_bwd_plain(x, wk, g)[0]) < tol
    exact = dw.depthwise_conv2d_bwd_plain(x.double(), wk.double(), g.double())
    assert _rel_err(dwt, exact[1]) < 1e-5 and _rel_err(db, exact[2]) < 1e-5
    assert torch.equal(dw.depthwise_conv2d(x, wk, bias), got)
    for again, first in zip(dw.depthwise_conv2d_bwd(x, wk, g), (dx, dwt, db)):
        assert torch.equal(again, first)
    assert (_build.tickets(cuda, 1) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_depthwise_kernels_launch_alone(cuda, dtype):
    """A call launches its kernel and nothing else (taps and bias read in
    place, no cast, no second sum); a CUDA tensor the kernels do not take
    raises."""
    x = _randn(cuda, 2, 30, 41, 64, dtype=dtype)
    g = _randn(cuda, 2, 30, 41, 64, dtype=dtype)
    wk = (0.2 * _randn(cuda, 64, 1, 7, 7)).permute(2, 3, 1, 0)
    bias = 0.1 * _randn(cuda, 64)
    names = _kernels_of(lambda: dw.depthwise_conv2d(x, wk, bias))
    assert len(names) == 1 and "dw7_fwd_kernel" in names[0], names
    names = _kernels_of(lambda: dw.depthwise_conv2d_bwd(x, wk, g))
    assert len(names) == 1 and "dw7_bwd_kernel" in names[0], names
    with pytest.raises(TypeError, match="taps"):
        dw.depthwise_conv2d(x, wk.half(), bias)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError, match="x's dtype"):
        dw.depthwise_conv2d_bwd(x, wk, g.to(other))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_depthwise_kernels_fit_without_spills(cuda, dtype):
    """No spills; the forward (four warps of 9 columns) at three blocks an
    SM, the backward (six conv and six weight warps of 6 columns) at one;
    36-column strips."""
    for backward, per_sm, threads in ((False, 3, 128), (True, 1, 384)):
        res = dw.kernel_resources(dtype, backward)
        assert res["spill_bytes"] == 0 and res["blocks_per_sm"] >= per_sm, res
        assert res["threads"] == threads and res["strip_columns"] == dw.STRIP, res


LN_BWD_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                (torch.float32, torch.float32), (torch.bfloat16, torch.float32)]


def _ln_bwd_operands(dev, layout, x_dtype, g_dtype):
    """x and dy as the step's norms and others hand them in: row-major
    rows, channel-major maps at batch 1 and 4 (the latter no row axis
    describes), a channel-major x with a row-major dy, odd widths (the
    column path at 250 and 37, the masked path at 600)."""
    cm = lambda b, c, n, dt: (3.0 * _randn(dev, b, c, n, dtype=dt)).transpose(1, 2)  # noqa: E731
    rm = lambda dt, *s: 3.0 * _randn(dev, *s, dtype=dt)  # noqa: E731
    return {
        "rows": lambda: (rm(x_dtype, 4 * 5184, 256), rm(g_dtype, 4 * 5184, 256)),
        "cmajor1": lambda: (cm(1, 256, 5184, x_dtype), cm(1, 256, 5184, g_dtype)),
        "cmajor4": lambda: (cm(4, 256, 5184, x_dtype), cm(4, 256, 5184, g_dtype)),
        "mixed": lambda: (cm(4, 256, 999, x_dtype), rm(g_dtype, 4, 999, 256)),
        "c250": lambda: (rm(x_dtype, 201, 250), rm(g_dtype, 201, 250)),
        "c37": lambda: (cm(2, 37, 300, x_dtype), cm(2, 37, 300, g_dtype)),
        "c600": lambda: (rm(x_dtype, 77, 600), rm(g_dtype, 77, 600)),
    }[layout]()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,g_dtype", LN_BWD_PAIRS)
@pytest.mark.parametrize("layout", ["rows", "cmajor1", "cmajor4", "mixed", "c250", "c37", "c600"])
def test_layer_norm_bwd_layouts_match_plain(cuda, x_dtype, g_dtype, layout):
    """Every (x, dy) dtype pair on each path: dx within 1e-2 (1e-4 when
    both are fp32), dw / db within 1e-4 of their range; one launch a call;
    the same bits when run again (the finish sums in a fixed order); the
    tickets left at 0."""
    x, g = _ln_bwd_operands(cuda, layout, x_dtype, g_dtype)
    c = x.shape[-1]
    w = 1.0 + 0.1 * _randn(cuda, c, dtype=torch.float32)
    before = ln.layer_norm_bwd.launches
    dx, dw_, db = ln.layer_norm_bwd(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd.launches == before + 1 and dx.dtype == x_dtype
    assert dx.shape == x.shape
    want = ln.layer_norm_bwd_plain(x, w, g, 1e-5)
    tol = FP32_TOL if x_dtype == g_dtype == torch.float32 else TOL
    assert _rel_err(dx, want[0]) < tol
    assert _rel_err(dw_, want[1]) < 1e-4 and _rel_err(db, want[2]) < 1e-4
    for again, first in zip(ln.layer_norm_bwd(x, w, g, 1e-5), (dx, dw_, db)):
        assert torch.equal(again, first)
    assert (_build.tickets(cuda, 1) == 0).all()


@pytest.mark.cuda
def test_layer_norm_bwd_launches_alone(cuda):
    """The step's channel-major batch of maps: one kernel a call (no copy
    of x or dy, no second sum)."""
    x, g = _ln_bwd_operands(cuda, "cmajor4", torch.bfloat16, torch.bfloat16)
    w = 1.0 + 0.1 * _randn(cuda, 256, dtype=torch.float32)
    names = _kernels_of(lambda: ln.layer_norm_bwd(x, w, g, 1e-5))
    assert len(names) == 1 and "ln_bwd_cols" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,g_dtype", LN_BWD_PAIRS)
def test_layer_norm_bwd_kernel_fits_without_spills(cuda, x_dtype, g_dtype):
    """At 256 row-major channels the vector path (one 16-byte vector a lane
    when both are bf16, two 4-column vectors otherwise), channel-major the
    column path, 600 channels the masked path: no spills, a block of 512
    threads resident on every SM (the grid)."""
    nv = 1 if x_dtype == g_dtype == torch.bfloat16 else 2
    for c, stride, path in ((256, 1, nv), (256, 5184, -1), (600, 1, 0)):
        res = ln.bwd_kernel_resources(x_dtype, g_dtype, c, col_stride=stride)
        assert res["path"] == path and res["spill_bytes"] == 0 and res["blocks_per_sm"] >= 1, res


# ---- the backward kernels' tickets by stream and by graph capture;
# rms_norm_2d's backward in CUDA (one launch); the tensor-core probe on wgmma


def _ticket_users(dev):
    """The three backward kernels that take tickets, at the tracker's and
    the Stage-3 step's shapes: (fn, plain, [(got, want) tolerances])."""
    x = _randn(dev, 8, 72, 72, 256)
    g = (1e-2 * _randn(dev, 8, 72, 72, 256, dtype=torch.float32)).to(torch.bfloat16)
    wk = (0.2 * _randn(dev, 256, 1, 7, 7)).permute(2, 3, 1, 0)
    xl, gl = _randn(dev, 4 * 5184, 256), _randn(dev, 4 * 5184, 256)
    wl = 1.0 + 0.1 * _randn(dev, 256, dtype=torch.float32)
    xr, gr = 3.0 * _randn(dev, 8, 72, 72, 256), _randn(dev, 8, 72, 72, 256)
    _, rstd = rn.rms_norm_2d_plain(xr, wl, wl, return_rstd=True)
    return [
        (lambda: dw.depthwise_conv2d_bwd(x, wk, g), lambda: dw.depthwise_conv2d_bwd_plain(x, wk, g)),
        (lambda: ln.layer_norm_bwd(xl, wl, gl, 1e-5), lambda: ln.layer_norm_bwd_plain(xl, wl, gl)),
        (lambda: rn.rms_norm_2d_bwd(xr, wl, rstd, gr),
         lambda: rn.rms_norm_2d_bwd_plain(xr, wl, rstd, gr)),
    ]


def _same_bits(got, want):
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_backward_tickets_on_two_streams(cuda):
    """The depthwise, LayerNorm and RMSNorm backward kernels launched on two
    streams at once, three rounds: every result is the bits of the same
    launch alone on the current stream (dw / db finished in a fixed order),
    within 1e-2 (dx) and 1e-4 (dw / db) of the plain versions; each stream
    has a ticket buffer of its own, and every buffer is back at 0."""
    users = _ticket_users(cuda)
    alone = [fn() for fn, _ in users]
    torch.cuda.synchronize()
    for got, (_, plain) in zip(alone, users):
        want = plain()
        assert _rel_err(got[0], want[0]) < TOL
        assert _rel_err(got[1], want[1]) < 1e-4 and _rel_err(got[2], want[2]) < 1e-4
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = {0: [], 1: []}
    for _ in range(3):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append([fn() for fn, _ in users])
    buffers = []
    for s in streams:
        with torch.cuda.stream(s):
            buffers.append(_build.tickets(cuda, 1).data_ptr())
    torch.cuda.synchronize()
    assert buffers[0] != buffers[1] != _build.tickets(cuda, 1).data_ptr()
    for rounds in outs.values():
        for results in rounds:
            for got, want in zip(results, alone):
                _same_bits(got, want)
    assert all((b == 0).all() for b in _build.ticket_buffers())


@pytest.mark.cuda
def test_backward_tickets_in_cuda_graphs(cuda):
    """The three backward kernels captured into two CUDA graphs: each
    capture's launches take a buffer of its own from the graph's pool (not
    an eager one, not the other graph's), zero-filled by the graph at every
    replay; the two graphs replayed at once on two streams, twice, give the
    bits of the eager launches, and the eager buffers stay at 0."""
    users = _ticket_users(cuda)
    alone = [fn() for fn, _ in users]
    eager = {b.data_ptr() for b in _build.ticket_buffers()}
    torch.cuda.synchronize()
    graphs = []
    for _ in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [fn() for fn, _ in users]
            held = _build.tickets(cuda, 1).data_ptr()
        graphs.append((graph, outs, held))
    assert graphs[0][2] != graphs[1][2] and not eager & {graphs[0][2], graphs[1][2]}
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(2):
        for s, (graph, _, _) in zip(streams, graphs):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                graph.replay()
        torch.cuda.synchronize()
        for _, outs, _ in graphs:
            for got, want in zip(outs, alone):
                _same_bits(got, want)
    assert all((b == 0).all() for b in _build.ticket_buffers())


RMS_CARD_SHAPES = [(8, 72, 72, 256), (4, 63, 63, 128), (3, 5, 7, 37), (2, 11, 13, 130),
                   (2, 9, 11, 384)]


def _rms_operands(dev, shape, dtype):
    c = shape[-1]
    x = (3.0 * _randn(dev, *shape, dtype=torch.float32)).to(dtype)
    w = 1.0 + 0.1 * _randn(dev, c, dtype=torch.float32)
    g = _randn(dev, *shape, dtype=dtype)
    _, rstd = rn.rms_norm_2d_plain(x, w, w, return_rstd=True)
    return x, w, g, rstd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", RMS_CARD_SHAPES, ids=str)
def test_rms_norm_2d_bwd_one_cuda_launch(cuda, shape, dtype):
    """rms_norm_2d's backward at the tracker's map, EV-M's stride-16 map at
    batch 4, and ragged rows and channels (37 and 130, and 384 past the
    vector path's 256: the masked path):
    one CUDA kernel a call (no Triton, no sum after it); the same bits when
    run again; dx within 1e-2 (bf16) or 1e-4 (fp32) of the plain version's
    largest magnitude; dw / db within 1e-5 of fp64 sums."""
    x, w, g, rstd = _rms_operands(cuda, shape, dtype)
    before = rn.rms_norm_2d_bwd.launches
    dx, dwt, db = rn.rms_norm_2d_bwd(x, w, rstd, g)
    torch.cuda.synchronize()
    assert rn.rms_norm_2d_bwd.launches == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape and dwt.dtype == db.dtype == torch.float32
    tol = TOL if dtype == torch.bfloat16 else FP32_TOL
    assert _rel_err(dx, rn.rms_norm_2d_bwd_plain(x, w, rstd, g)[0]) < tol
    c = shape[-1]
    xhat = x.double().reshape(-1, c) * rstd.double()[:, None]
    gd = g.double().reshape(-1, c)
    assert _rel_err(dwt, (gd * xhat).sum(0)) < 1e-5 and _rel_err(db, gd.sum(0)) < 1e-5
    _same_bits(rn.rms_norm_2d_bwd(x, w, rstd, g), (dx, dwt, db))
    names = _kernels_of(lambda: rn.rms_norm_2d_bwd(x, w, rstd, g))
    want = "ln_bwd_vec" if c % 8 == 0 and c <= 256 else "ln_bwd_any"
    assert len(names) == 1 and want in names[0], names
    assert (_build.tickets(cuda, 1) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_rms_norm_2d_bwd_kernel_fits_without_spills(cuda, dtype):
    """At 256 and 128 channels the vector path (one 16-byte vector a lane
    in bf16, two 4-column vectors in fp32 at 256), at 130 the masked path,
    and at 384 and 512 too (the vector path's instantiations there spilled):
    no spills, a block of 512 threads resident on every SM."""
    for c, path in ((256, 1 if dtype == torch.bfloat16 else 2), (128, 1), (130, 0), (384, 0),
                    (512, 0)):
        res = rn.bwd_kernel_resources(dtype, dtype, c)
        assert res["path"] == path and res["spill_bytes"] == 0 and res["blocks_per_sm"] >= 1, res


@pytest.mark.cuda
def test_rms_norm_2d_bwd_refuses_what_it_does_not_take(cuda):
    x, w, g, rstd = _rms_operands(cuda, (2, 3, 5, 64), torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rn.rms_norm_2d_bwd(x.half(), w, rstd, g)
    with pytest.raises(ValueError, match="too wide"):
        big = torch.zeros((2, 4100), dtype=torch.bfloat16, device=cuda)
        rn.rms_norm_2d_bwd(big, torch.ones(4100, device=cuda), torch.ones(2, device=cuda), big)
    with pytest.raises(ValueError, match="rstd"):
        rn.rms_norm_2d_bwd(x, w, rstd[:-1], g)


@pytest.mark.cuda
def test_mma_probe_on_wgmma_fits_without_spills(cuda):
    """The chain's kernels (int8, bf16) at k = 256: no spills, three blocks of one warpgroup an SM (the 384 tiles of the
    probe's shape in one wave); no source under csrc/ issues mma.sync (its
    code, comments left out)."""
    import re
    from pathlib import Path

    from efficientsam3_tpu_torch.ops import mma_probe

    for dtype in (torch.int8, torch.bfloat16):
        res = mma_probe.kernel_resources(dtype)
        assert res["spill_bytes"] == 0 and res["blocks_per_sm"] >= 3, (dtype, res)
    for path in Path(_build.CSRC).glob("*.cu*"):
        assert "mma.sync" not in re.sub(r"//[^\n]*", "", path.read_text()), path.name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.int8, 256), (torch.int8, 992), (torch.bfloat16, 496)])
def test_mma_probe_long_rows_and_clocks(cuda, dtype, k):
    """Rows the registers hold (int8 k = 256) and longer ones (int8 k =
    992, bf16 k = 496: A's further k-steps from shared memory) within 1e-5
    of the plain chain; the clock64 sections are taken and leave the output
    as it is."""
    from efficientsam3_tpu_torch.ops import mma_probe

    x, y = mma_probe.probe_operands(dtype, 200, k, 300, seed=5, device=cuda)
    got = mma_probe.dot_chain(x, y, 5)
    torch.cuda.synchronize()
    assert _rel_err(got, mma_probe.dot_chain_plain(x, y, 5)) < 1e-5
    before = mma_probe.dot_chain.launches
    sections, out = mma_probe.chain_clocks(x, y, 5)
    assert mma_probe.dot_chain.launches == before and torch.equal(out, got)
    assert all(v > 0 for v in sections.values()), sections


@pytest.mark.cuda
def test_xattn_rpb_route_by_gradient(cuda):
    """The decoder's boxRPB cross-attention (MultiheadAttention(rpb=...))
    in eval mode: under no_grad one flash_xattn_rpb launch; with an input
    that needs a gradient (the geometry finetune's frozen heads) no launch,
    the matmul path with the full bias, within bf16 rounding of the
    kernel's output, and a gradient back to that input."""
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.models.common import MultiheadAttention

    mha = init_parameters(MultiheadAttention(256, 8, dtype=torch.bfloat16), seed=3).to(cuda)
    mha.eval()
    hw = (18, 27)
    q = _randn(cuda, 2, 201, 256)
    mem = _randn(cuda, 2, hw[0] * hw[1], 256)
    ey = _randn(cuda, 2, 8, 201, hw[0], dtype=torch.float32)
    ex = _randn(cuda, 2, 8, 201, hw[1], dtype=torch.float32)
    n = fa.flash_xattn_rpb.launches
    with torch.no_grad():
        want = mha(q, mem, mem, rpb=(ey, ex, hw))
    torch.cuda.synchronize()
    assert fa.flash_xattn_rpb.launches == n + 1
    mem_g = mem.clone().requires_grad_()
    got = mha(q, mem_g, mem_g, rpb=(ey, ex, hw))
    assert fa.flash_xattn_rpb.launches == n + 1
    assert _rel_err(got.detach(), want) < 2e-2
    got.float().square().sum().backward()
    assert mem_g.grad is not None and torch.isfinite(mem_g.grad.float()).all()


@pytest.mark.cuda
def test_geometry_step_launches(cuda):
    """One geometry finetune step of an EfficientViT-b0 model at 1008^2
    (2 fusion and 2 decoder layers, bf16, batch 1, one box): per fusion
    layer one flash_sdpa forward, one dq and one dkv; every kernel
    LayerNorm (the fusion and geometry encoders' FusedLayerNorm modules)
    once forward and once backward; no flash_xattn_rpb. The eval ground
    after it under no_grad launches flash_xattn_rpb once a decoder layer."""
    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.models.common import FusedLayerNorm
    from efficientsam3_tpu_torch.models.geometry import Prompt
    from efficientsam3_tpu_torch.train import geometry_finetune as gf

    model = build_efficientsam3_image_model(
        model_name="b0", text_encoder_context_length=16, fusion_layers=2, decoder_layers=2,
        dtype=torch.bfloat16, device=cuda, seed=2)
    cfg = gf.GeometryFinetuneConfig()
    opt = gf.make_geometry_optimizer(cfg, model)
    tok = torch.zeros((1, 16), dtype=torch.long, device=cuda)
    tok[0, :3] = torch.tensor([49406, 320, 49407])
    prompt = Prompt.empty(1, 2, 2, device=cuda).with_box(0, 0, [0.5, 0.5, 0.3, 0.3])
    batch = {"images": _randn(cuda, 1, 1008, 1008, 3, dtype=torch.float32), "tokens": tok,
             "prompt": prompt, "teacher_embed": _randn(cuda, 1, 72, 72, 1024),
             "valid": torch.ones((1, 72, 72), device=cuda),
             "teacher_mask": torch.zeros((1, 288, 288), device=cuda)}
    counters = {"flash_sdpa": fa.flash_sdpa, "flash_sdpa_bwd_dq": fa.flash_sdpa_bwd_dq,
                "flash_sdpa_bwd_dkv": fa.flash_sdpa_bwd_dkv, "layer_norm": ln.layer_norm,
                "layer_norm_bwd": ln.layer_norm_bwd, "flash_xattn_rpb": fa.flash_xattn_rpb}
    n_ln = sum(isinstance(m, FusedLayerNorm) for m in model.modules())
    want = {"flash_sdpa": 2, "flash_sdpa_bwd_dq": 2, "flash_sdpa_bwd_dkv": 2,
            "layer_norm": n_ln, "layer_norm_bwd": n_ln, "flash_xattn_rpb": 0}
    for w in counters.values():
        w.launches = 0
    metrics = gf.geometry_finetune_step(model, opt, cfg, batch)
    torch.cuda.synchronize()
    assert {k: w.launches for k, w in counters.items()} == want and n_ln == 2 * 3 + 3 * 3
    assert np.isfinite(float(metrics["loss"]))
    fa.flash_xattn_rpb.launches = 0
    with torch.no_grad():
        model(batch["images"], tok, prompt)
    assert fa.flash_xattn_rpb.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("orig_hw", [(600, 800), (200, 150)], ids=["up", "down"])
def test_postprocess_image_on_the_card_matches_cpu(cuda, orig_hw):
    """eval.postprocess_image over ground-shaped bf16 outputs on the card
    (masks upsampled and thresholded there) against the same function on a
    CPU copy: equal scores and boxes, and masks equal except where the CPU's
    upsampled logit lies within 1e-3 of 0."""
    from efficientsam3_tpu_torch.eval.coco_format import rle_to_mask
    from efficientsam3_tpu_torch.eval.postprocess import postprocess_image
    from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear

    out = {"pred_logits": _randn(cuda, 1, 200, 1), "pred_boxes": torch.rand(
        1, 200, 4, device=cuda).to(torch.bfloat16), "pred_masks": 4 * _randn(cuda, 1, 200, 288, 288),
        "presence_logit_dec": _randn(cuda, 1)}
    cpu = {k: v.cpu() for k, v in out.items()}
    got = postprocess_image(out, 3, orig_hw=orig_hw)
    want = postprocess_image(cpu, 3, orig_hw=orig_hw)
    assert len(got) == len(want) == 100
    scores = torch.sigmoid(cpu["pred_logits"][0, :, 0].double()).numpy()
    order = np.argsort(-scores)
    differ = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["score"] == w["score"] and g["bbox"] == w["bbox"]
        diff = rle_to_mask(g["segmentation"]) != rle_to_mask(w["segmentation"])
        if diff.any():
            logit = resize_bilinear(cpu["pred_masks"][0, order[i]].float()[None, None], orig_hw)
            assert (np.abs(logit[0, 0].numpy()[diff]) < 1e-3).all()
            differ += int(diff.sum())
    assert differ <= 1e-4 * 100 * orig_hw[0] * orig_hw[1]
