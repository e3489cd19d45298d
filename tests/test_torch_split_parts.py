"""The split of fp32 operands into bf16 parts that the fp32 attention
backward kernels on wgmma read (``flash_attention.split_parts``: head dim
256, and at head dims 32, 64 and 80 the dkv kernel's Q and dO and the dq
kernel's K and V), its
plain version held against the rule written out in numpy: hi is x rounded
to the nearest bf16 (ties to even), lo is x - hi rounded the same way, and
|x - hi - lo| <= max(2^-16 |x|, 2^-134) (the second term: half the spacing
of bf16's subnormals, where lo or x itself is subnormal). The card test in
tests/test_torch_cuda.py holds the kernel to this plain version bit for
bit. Runs on the CPU.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

from efficientsam3_tpu_torch.ops import flash_attention as fa

RNG = np.random.default_rng(29)


def _bf16_rne(x):
    """float32 values rounded to bf16 (nearest, ties to even), as float32:
    the top 16 bits of x plus the rounding carry (finite x below bf16's
    largest value)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32)


def _bits(t):
    return t.float().numpy().view(np.uint32)


def _normals():
    return (RNG.standard_normal(4096) * 10.0 ** RNG.integers(-30, 30, 4096)).astype(np.float32)


def _subnormals():
    mant = RNG.integers(1, 1 << 23, 2048, dtype=np.uint32)
    sign = RNG.integers(0, 2, 2048, dtype=np.uint32) << 31
    return (mant | sign).view(np.float32)


def _zeros():
    return np.array([0.0, -0.0, 2.0 ** -126, -(2.0 ** -126), 2.0 ** -149], np.float32)


def _large():
    mag = 10.0 ** RNG.uniform(30, 38, 2048) * RNG.choice([-1.0, 1.0], 2048)
    return np.clip(mag, -3.0e38, 3.0e38).astype(np.float32)


def _ties():
    # the low 16 bits exactly half a bf16 ulp: upper halves even and odd
    upper = RNG.integers(0x0080, 0x7F00, 2048, dtype=np.uint32)
    sign = RNG.integers(0, 2, 2048, dtype=np.uint32) << 31
    x = ((upper << 16) | 0x8000 | sign).view(np.float32)
    # and ties for lo: x = 2^e (1 + r), r = 2^-9 (1 + k / 128 + 1 / 256), so
    # hi = 2^e and x - hi lies halfway between two bf16 values
    k = RNG.integers(0, 128, 1024)
    e = RNG.integers(-20, 21, 1024).astype(np.float64)
    r = 2.0 ** -9 * (1.0 + k / 128.0 + 1.0 / 256.0)
    lo_tie = (RNG.choice([-1.0, 1.0], 1024) * 2.0 ** e * (1.0 + r)).astype(np.float32)
    return np.concatenate([x, lo_tie])


@pytest.mark.parametrize("make", [_normals, _subnormals, _zeros, _large, _ties],
                         ids=["normals", "subnormals", "zeros", "large", "ties"])
def test_split_parts_plain_follows_the_rule(make):
    x = make()
    assert np.isfinite(x).all()
    parts = fa.split_parts_plain(torch.from_numpy(x))
    assert parts.shape == (2, *x.shape) and parts.dtype == torch.bfloat16
    hi, lo = parts[0], parts[1]
    want_hi = _bf16_rne(x)
    want_lo = _bf16_rne((x - want_hi).astype(np.float32))
    np.testing.assert_array_equal(_bits(hi), want_hi.view(np.uint32))
    np.testing.assert_array_equal(_bits(lo), want_lo.view(np.uint32))
    resid = np.abs(x.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    assert (resid <= np.maximum(2.0 ** -16 * np.abs(x.astype(np.float64)), 2.0 ** -134)).all()


def test_split_parts_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version, liveness ignored: a
    (B, H, N, 256) view in, (2, B, H, N, 256) bf16 out, no launch counted."""
    x = torch.from_numpy(RNG.standard_normal((2, 5, 3, 256)).astype(np.float32)).transpose(1, 2)
    before = fa.split_parts.launches
    got = fa.split_parts(x, torch.zeros((2, 5)), 32)
    assert fa.split_parts.launches == before
    assert torch.equal(got, fa.split_parts_plain(x)) and got.shape == (2, 2, 3, 5, 256)
    torch.testing.assert_close(got[0].float() + got[1].float(), x, atol=0, rtol=2.0 ** -16)


@pytest.mark.parametrize("d,tile,ok", [(32, 0, True), (256, 0, True), (256, 32, True),
                                       (32, 32, False), (64, 0, True), (80, 0, True),
                                       (128, 0, False), (64, 32, True), (80, 32, False),
                                       (48, 0, False), (96, 0, False), (128, 32, False)])
def test_split_parts_takes_d32_and_d256_only(d, tile, ok):
    """What the CUDA split pass is handed (``check_split_parts``, the
    wrapper's check before a launch): float32 (B, H, N, d) at d=32, 64 and
    80 (the fp32 dkv kernel's Q and dO and the fp32 dq kernel's K and V,
    every row) and d=256; skipping dead key tiles at d=256 and d=64 (the
    fp32 forwards' K and V at d=256 and the bank kernel's values); every
    other width, or another dtype, refused."""
    x = torch.zeros((2, 3, 5, d))
    bias = torch.zeros((2, 5))
    if ok:
        fa.check_split_parts(x, bias, tile)
    else:
        with pytest.raises(ValueError, match="split_parts"):
            fa.check_split_parts(x, bias, tile)
    with pytest.raises(ValueError, match="float32"):
        fa.check_split_parts(x.to(torch.bfloat16), bias, tile)
