"""The tracker's kernels in the PyTorch port: each plain version held against
the JAX Pallas kernel it replaces (interpret mode on the CPU), with inputs
made by numpy from a seed. The hand-written CUDA kernels are held against
these plain versions on a card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax.numpy as jnp
from flax import linen as fnn

from efficientsam3_tpu.models import common as jc
from efficientsam3_tpu.ops.pallas import flash_attention as jfa
from efficientsam3_tpu.ops.pallas.depthwise import depthwise_conv2d as jax_depthwise
from efficientsam3_tpu_torch.models import common as pc
from efficientsam3_tpu_torch.ops import depthwise as dw
from efficientsam3_tpu_torch.ops import flash_attention as fa

RNG = np.random.default_rng(21)

# fp32 on both sides; online against two-pass softmax and other summation
# orders: ~1e-6 relative, 1e-5 leaves margin
TOL = 1e-5


def _randn(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def test_flash_sdpa_plain_d256_matches_pallas():
    """Head dim 256, one head (the memory attention): ragged Lq/Lk over 32 x
    64 blocks, a masked 64-key block, a fully masked batch row (an empty
    object slot: 0 out, lse -1e9), and the LSE."""
    b, lq, lk, d = 3, 100, 200, 256
    q, k, v = _randn(b, 1, lq, d, scale=0.2), _randn(b, 1, lk, d, scale=0.2), _randn(b, 1, lk, d)
    bias = np.zeros((b, lk), np.float32)
    bias[0, 64:128] = jfa.NEG_INF
    bias[0, 190:] = jfa.NEG_INF
    bias[1] = jfa.NEG_INF
    want_o, want_lse = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                      1.0 / 16.0, 32, 64, True, return_lse=True)
    got_o, got_lse = fa.flash_sdpa_plain(*_t(q, k, v, bias), return_lse=True)
    _assert_close(got_o, want_o)
    _assert_close(got_lse, want_lse)
    assert np.all(got_o[1].numpy() == 0.0) and np.all(got_lse[1].numpy() == jfa.NEG_INF)


def _memattn_inputs(b=3, lq=70, lk=300, dk=256, dv=64):
    q, k, v = _randn(b, 1, lq, dk, scale=0.2), _randn(b, 1, lk, dk, scale=0.2), _randn(b, 1, lk, dv)
    bias = np.zeros((b, lk), np.float32)
    bias[0, 100:200] = jfa.NEG_INF  # an invalid bank entry
    bias[0, 280:] = jfa.NEG_INF  # the pad tail
    bias[1] = jfa.NEG_INF  # an empty object slot
    return q, k, v, bias


def test_flash_memattn_plain_matches_pallas():
    """dk 256 against raw dv 64 values over 128-key blocks, a masked entry
    and pad tail, a fully masked row (0 out, lse -1e9), and the LSE.

    The port sums the softmax denominator in fp32 from the unrounded P (the
    einsum path's choice); the Pallas kernel sums it through a ones row of
    the AV product from P cast to v's dtype. With fp32 values both sums are
    the same fp32 numbers, so the two agree to fp32 rounding here; with bf16
    values they would differ by ~2^-9 relative."""
    q, k, v, bias = _memattn_inputs()
    want_o, want_lse = jfa.flash_memattn(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                         block_q=128, block_k=128, interpret=True,
                                         return_lse=True)
    before = fa.flash_memattn.launches
    got_o, got_lse = fa.flash_memattn(*_t(q, k, v, bias), return_lse=True)
    assert fa.flash_memattn.launches == before  # CPU tensors take the plain version
    _assert_close(got_o, want_o)
    _assert_close(got_lse, want_lse)
    assert np.all(got_o[1].numpy() == 0.0) and np.all(got_lse[1].numpy() == jfa.NEG_INF)
    _assert_close(fa.flash_memattn(*_t(q, k, v, bias)), want_o)


def _split_matmul(a, b):
    """a @ b as the fp32 kernels form it on the tensor cores: both operands
    as split bf16 parts (``split_parts_plain``), hi hi + hi lo + lo hi (the
    lo lo term dropped), summed in float64 and returned in fp32."""
    ah, al = (x.double() for x in fa.split_parts_plain(a))
    bh, bl = (x.double() for x in fa.split_parts_plain(b))
    return (ah @ bh + ah @ bl + al @ bh).float()


def _split_attention(q, k, v, bias, scale):
    """The arithmetic of the fp32 forward kernels (flash_sdpa_h_fp32.cu at
    d=256, flash_memattn_h.cu in fp32): S and P V on split parts, P kept
    fp32 (split again for its product), the denominator from the unsplit
    P, a fully masked batch row 0 with lse -1e9."""
    logits = _split_matmul(q, k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = _split_matmul(p, v) / l
    lse = (m + torch.log(l))[..., 0]
    live = (bias > fa.NEG_INF / 2).any(-1)[:, None, None]
    return (torch.where(live[..., None], out, torch.zeros_like(out)),
            torch.where(live, lse, torch.full_like(lse, fa.NEG_INF)))


def test_flash_sdpa_d256_split_parts_match_pallas():
    """fp32 at d=256: the split-part arithmetic of the fp32 wgmma forward
    (three bf16 products a product, P split) on the d=256 parity test's
    inputs (ragged Lq/Lk, a masked 64-key block, an empty object slot, the
    LSE) against the Pallas kernel in interpret mode, within the 1e-4 the
    card holds the kernel to against its plain version."""
    b, lq, lk, d = 3, 100, 200, 256
    r = np.random.default_rng(22)
    q, k = ((0.2 * r.standard_normal((b, 1, n, d))).astype(np.float32) for n in (lq, lk))
    v = r.standard_normal((b, 1, lk, d)).astype(np.float32)
    bias = np.zeros((b, lk), np.float32)
    bias[0, 64:128] = jfa.NEG_INF
    bias[0, 190:] = jfa.NEG_INF
    bias[1] = jfa.NEG_INF
    want_o, want_lse = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                      1.0 / 16.0, 32, 64, True, return_lse=True)
    got_o, got_lse = _split_attention(*_t(q, k, v, bias), 1.0 / 16.0)
    _assert_close(got_o, want_o, 1e-4)
    _assert_close(got_lse, want_lse, 1e-4)
    assert np.all(got_o[1].numpy() == 0.0) and np.all(got_lse[1].numpy() == jfa.NEG_INF)


def test_flash_memattn_split_parts_match_pallas():
    """fp32 bank attention: the split-part arithmetic of flash_memattn_h.cu's
    fp32 form (dk 256 against raw dv 64 values) on the bank parity test's
    inputs (a masked entry, the pad tail, an empty slot, the LSE) against
    the Pallas kernel in interpret mode, within 1e-4."""
    q, k, v, bias = _memattn_inputs()
    want_o, want_lse = jfa.flash_memattn(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                         block_q=128, block_k=128, interpret=True,
                                         return_lse=True)
    got_o, got_lse = _split_attention(*_t(q, k, v, bias), 1.0 / 16.0)
    _assert_close(got_o, want_o, 1e-4)
    _assert_close(got_lse, want_lse, 1e-4)
    assert np.all(got_o[1].numpy() == 0.0) and np.all(got_lse[1].numpy() == jfa.NEG_INF)


def test_memattn_segment_merge_matches_jax():
    """The cached tracker's two segments: the bank through flash_memattn
    (a fully masked row ends at lse -1e9) and the pointer tokens through
    the einsum path (lse -inf where masked), merged by log-sum-exp. Row 1's
    bank is empty, so its output is the pointer segment alone; row 2 has
    no valid pointer, so its output is the bank segment alone."""
    q, k, v, bias = _memattn_inputs()
    kp, vp = _randn(3, 1, 16, 256, scale=0.2), _randn(3, 1, 16, 64)
    pmask = np.ones((3, 1, 1, 16), bool)
    pmask[0, ..., 12:] = False
    pmask[2] = False
    jm = jfa.flash_memattn(*(jnp.asarray(a) for a in (q, k, v, bias)), block_q=128,
                           block_k=128, interpret=True, return_lse=True)
    jp = jc.sdpa_rawv(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pmask),
                      return_lse=True)
    want = jc.merge_attention_segments([jm, jp])
    pm = fa.flash_memattn(*_t(q, k, v, bias), return_lse=True)
    pp = pc.sdpa_rawv(*_t(q, kp, vp), torch.from_numpy(pmask), return_lse=True)
    _assert_close(pp[0], jp[0])
    masked = np.isneginf(np.asarray(jp[1]))
    np.testing.assert_array_equal(np.isneginf(pp[1].numpy()), masked)
    _assert_close(pp[1].numpy()[~masked], np.asarray(jp[1])[~masked])
    got = pc.merge_attention_segments([pm, pp])
    _assert_close(got, want)
    _assert_close(got[1], pp[0][1])
    _assert_close(got[2], pm[0][2])


@pytest.mark.parametrize("shape", [(2, 9, 11, 24), (1, 6, 5, 130)])
def test_depthwise_plain_matches_pallas_and_flax_conv(shape):
    """Same-padded 7x7 depthwise conv, odd H/W, C not a multiple of 128
    (the port's kernel takes any C): the plain version against the Pallas
    kernel in interpret mode and against flax nn.Conv(feature_group_count=C)."""
    c = shape[-1]
    x = _randn(*shape)
    kernel = _randn(7, 7, 1, c, scale=0.2)
    bias = _randn(c, scale=0.1)
    want_pallas = jax_depthwise(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), True)
    conv = fnn.Conv(c, (7, 7), padding=3, feature_group_count=c)
    want_conv = conv.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                           jnp.asarray(x))
    before = dw.depthwise_conv2d.launches
    got = dw.depthwise_conv2d(*_t(x, kernel, bias))
    assert dw.depthwise_conv2d.launches == before
    _assert_close(got, want_pallas)
    _assert_close(got, want_conv)


def test_padded_bank_len_matches_jax():
    for n in (1, 127, 128, 2047, 2048, 2049, 7 * 5184, 7 * 64):
        assert fa.padded_bank_len(n) == jfa.padded_bank_len(n)
