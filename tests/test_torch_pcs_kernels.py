"""The int8 key bank's arithmetic and the tensor-core probe in the PyTorch
port against the JAX package, on the CPU.

``quantize_rows`` against the JAX function; ``flash_memattn_q8_plain`` (what
the CUDA kernel computes, and what the wrapper runs for CPU tensors)
against the Pallas kernel in interpret mode at the shapes of
tests/test_flash_attention.py, with and without the log-sum-exp, and
against unquantized attention; ``sdpa_rawv`` with a quantized key pair
against the JAX dequantize fallback; the probe's plain chain against numpy.
The same numpy inputs, made from a seed, go through both packages in fp32.
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax.numpy as jnp

from efficientsam3_tpu.models import common as jcommon
from efficientsam3_tpu.ops.pallas import flash_attention as jfa
from efficientsam3_tpu_torch.models import common as pcommon
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.ops import mma_probe

NEG_INF = fa.NEG_INF
# fp32 on both sides over the same int8 operands: the integer products are
# exact, the scaling and the softmax sums round in other orders (the JAX
# test's own bound against its einsum reference)
TOL = 3e-5
SHAPES = [(2, 1, 96, 256, 64, 16), (1, 1, 64, 128, 32, 8)]


def _inputs(b, h, lq, lk, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, dk)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, dk)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, dv)).astype(np.float32)
    bias = np.zeros((b, lk), np.float32)
    bias[:, lk - 13:] = NEG_INF
    return q, k, v, bias


@pytest.mark.parametrize("case", ["fp32", "bf16", "zero_rows_scaled"])
def test_quantize_rows_matches_jax(case):
    """int8 values equal; scales equal to fp32 ulps (both divide |max| by
    127 and multiply by scale_mul in fp32). A zero row gets zeros and scale
    scale_mul * 1e-8 / 127."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 40, 64)) * rng.uniform(0.01, 30, (3, 40, 1))).astype(np.float32)
    mul = 1.0
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    if case == "bf16":
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    if case == "zero_rows_scaled":
        x[1, 5:9] = 0
        mul = 1.0 / np.sqrt(64)
        jx, px = jnp.asarray(x), torch.from_numpy(x)
    ji, js = jfa.quantize_rows(jx, scale_mul=mul)
    pi, ps = fa.quantize_rows(px, scale_mul=mul)
    assert pi.dtype == torch.int8 and ps.dtype == torch.float32 and ps.shape == (3, 40, 1)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=3e-7, atol=0)
    if case == "zero_rows_scaled":
        assert (pi[1, 5:9] == 0).all()
        np.testing.assert_allclose(ps[1, 5:9].numpy(), mul * 1e-8 / 127, rtol=1e-6)
    # dequantized rows are within half a step of the input
    err = (pi.float() * ps / mul - px.float()).abs()
    assert (err <= 0.5 * ps / mul * (1 + 1e-5)).all()


# bf16 q and v: both round P to bf16 for P V and the output to bf16, but
# the Pallas kernel sums the rounded P for the denominator (its ones row)
# where the port sums the unrounded fp32 P (~2^-9 apart), and a bf16
# output is 2^-8 relative: 1e-2, atol and rtol, on output and LSE
TOL_BF16 = 1e-2


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_memattn_q8_plain_matches_jax_kernel(shape, return_lse, dtype):
    """The plain version of the CUDA kernel == the Pallas q8 kernel
    (interpret mode, block_q 32, block_k 64) on the same int8 bank, with fp32
    or bf16 q and v (the masked tail of _inputs in both)."""
    q, k, v, bias = _inputs(*shape)
    jq, jv, pq, pv = jnp.asarray(q), jnp.asarray(v), torch.from_numpy(q), torch.from_numpy(v)
    tol = TOL
    if dtype == "bf16":
        jq, jv = jq.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        pq, pv = pq.bfloat16(), pv.bfloat16()
        tol = TOL_BF16
    ji, js = jfa.quantize_rows(jnp.asarray(k))
    want = jfa.flash_memattn_q8(jq, ji, js[..., 0][:, 0], jv, jnp.asarray(bias), block_q=32,
                                block_k=64, interpret=True, return_lse=return_lse)
    pi, ps = fa.quantize_rows(torch.from_numpy(k))
    got = fa.flash_memattn_q8(pq, pi, ps[:, 0, :, 0], pv, torch.from_numpy(bias),
                              return_lse=return_lse)
    if return_lse:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=tol, rtol=tol)
        got, want = got[0], want[0]
    assert got.dtype == pv.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_memattn_q8_plain_close_to_unquantized(shape):
    """Within 2e-2 of the output's largest magnitude of exact attention (the
    serving-mode bound of the JAX test), and not identical to it."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(*shape))
    pi, ps = fa.quantize_rows(k)
    got = fa.flash_memattn_q8_plain(q, pi, ps[:, 0, :, 0], v, bias)
    exact = fa.flash_memattn_plain(q, k, v, bias)
    rel = ((got - exact).abs().max() / exact.abs().max()).item()
    assert 0 < rel < 2e-2, rel


def test_flash_memattn_q8_masked_rows_and_zero_queries():
    """A slot whose keys are all masked gives 0 with lse -1e9 (every tile
    skipped); an all-zero query row has logits exactly 0 and averages the
    live values; masked keys carry no weight."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(2, 1, 8, 128, 32, 8, seed=1))
    q[0, 0, 2] = 0
    bias[1] = NEG_INF
    pi, ps = fa.quantize_rows(k)
    out, lse = fa.flash_memattn_q8_plain(q, pi, ps[:, 0, :, 0], v, bias, return_lse=True)
    assert (out[1] == 0).all() and (lse[1] == NEG_INF).all()
    live = 128 - 13
    torch.testing.assert_close(out[0, 0, 2], v[0, 0, :live].mean(0), atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(lse[0, 0, 2], torch.tensor(float(np.log(live))), atol=1e-5, rtol=0)
    v2 = v.clone()
    v2[0, 0, live:] = 1e6  # masked keys' values must not reach the output
    out2 = fa.flash_memattn_q8_plain(q, pi, ps[:, 0, :, 0], v2, bias)
    torch.testing.assert_close(out2[0], out[0], atol=0, rtol=0)


def test_flash_memattn_q8_requires_padded_bank():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 100, 32, 8))
    pi, ps = fa.quantize_rows(k)
    with pytest.raises(ValueError, match="pre-padded"):
        fa.flash_memattn_q8(q, pi, ps[:, 0, :, 0], v, bias)
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 128, 32, 8))
    pi, ps = fa.quantize_rows(k)
    with pytest.raises(ValueError, match="shapes"):  # k_scale is (B, Lk), not (B, 1, Lk, 1)
        fa.flash_memattn_q8(q, pi, ps, v, bias)
    with pytest.raises(ValueError, match="shapes"):  # the keys must be int8
        fa.flash_memattn_q8(q, k, ps[:, 0, :, 0], v, bias)


def test_flash_memattn_q8_cpu_wrapper_takes_the_plain_version():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(*SHAPES[1]))
    pi, ps = fa.quantize_rows(k)
    before = fa.flash_memattn_q8.launches
    got = fa.flash_memattn_q8(q, pi, ps[:, 0, :, 0], v, bias)
    assert fa.flash_memattn_q8.launches == before  # counts kernel launches only
    want = fa.flash_memattn_q8_plain(q, pi, ps[:, 0, :, 0], v, bias)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("return_lse", [False, True])
def test_sdpa_rawv_quantized_key_matches_jax_fallback(return_lse):
    """sdpa_rawv with a (k_i8, k_scale) pair: on the CPU both packages
    dequantize k and run the einsum path (q is not rounded there). 2e-5:
    fp32 sums in other orders."""
    q, k, v, bias = _inputs(2, 1, 24, 128, 32, 8, seed=2)
    mask = bias > NEG_INF / 2
    ji, js = jfa.quantize_rows(jnp.asarray(k))
    want = jcommon.sdpa_rawv(jnp.asarray(q), (ji, js), jnp.asarray(v),
                             mask=jnp.asarray(mask)[:, None, None, :], return_lse=return_lse)
    pi, ps = fa.quantize_rows(torch.from_numpy(k))
    got = pcommon.sdpa_rawv(torch.from_numpy(q), (pi, ps), torch.from_numpy(v),
                            mask=torch.from_numpy(mask)[:, None, None, :], return_lse=return_lse)
    if return_lse:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5, rtol=2e-5)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    # and it is the dequantized keys' attention, not the exact keys'
    deq = pcommon.sdpa_rawv(torch.from_numpy(q), pi.float() * ps, torch.from_numpy(v),
                            mask=torch.from_numpy(mask)[:, None, None, :])
    np.testing.assert_allclose(np.asarray(got), deq.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_dot_chain_plain_matches_numpy(dtype):
    """The probe's chain: sum_i (x @ y) * (1 + i). int8 products against
    numpy int32 (exact; the fp32 chain rounds: 1e-6); bf16 products against
    float64 (fp32 sums over k = 64: 1e-5 of the largest magnitude)."""
    x, y = mma_probe.probe_operands(dtype, 24, 64, 40, seed=1, device="cpu")
    before = mma_probe.dot_chain.launches
    got = mma_probe.dot_chain(x, y, 5).numpy()
    assert mma_probe.dot_chain.launches == before and got.dtype == np.float32
    if dtype == torch.int8:
        assert x.min() >= -127 and x.max() <= 126
        d = x.numpy().astype(np.int32) @ y.numpy().astype(np.int32)
        tol = 1e-6
    else:
        d = x.float().numpy().astype(np.float64) @ y.float().numpy().astype(np.float64)
        tol = 1e-5
    want = d * sum(1 + i for i in range(5))
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_dot_chain_refuses_other_operands():
    x = torch.zeros((4, 32))
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        mma_probe.dot_chain(x, x.T)
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        mma_probe.dot_chain(x.to(torch.int8), x.T.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        mma_probe.dot_chain(x.to(torch.int8), x.to(torch.int8))
