"""Kernels of the PyTorch port: each plain version held against the JAX
Pallas kernel it replaces (interpret mode on the CPU). The hand-written
kernels themselves are held against these plain versions on a card in
tests/test_torch_cuda.py.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficientsam3_tpu.models.common import sdpa as jax_sdpa
from efficientsam3_tpu.ops.pallas import flash_attention as jfa
from efficientsam3_tpu.ops.pallas.layer_norm import layer_norm as jax_layer_norm
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.ops import layer_norm as ln

RNG = np.random.default_rng(11)

# fp32 on both sides; the kernels' online softmax and the plain version's
# two-pass softmax sum in other orders: ~1e-6 relative, 1e-5 leaves margin
TOL = 1e-5


def _randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _sdpa_inputs(b=2, h=8, lq=100, lk=200, d=32):
    q, k, v = _randn(b, h, lq, d), _randn(b, h, lk, d), _randn(b, h, lk, d)
    bias = np.zeros((b, lk), np.float32)
    bias[0, 64:128] = jfa.NEG_INF  # one whole 64-key block masked (skipped)
    bias[0, 190:] = jfa.NEG_INF  # and a ragged tail
    bias[1:, :] = jfa.NEG_INF  # a batch row with every key masked
    return q, k, v, bias


@pytest.mark.parametrize("packed,d", [
    pytest.param(True, 32, id="packed"), pytest.param(False, 32, id="per_head"),
    pytest.param(True, 64, id="packed-d64"), pytest.param(False, 64, id="per_head-d64"),
])
def test_flash_sdpa_plain_matches_pallas(packed, d):
    """Ragged Lq/Lk, a fully masked key block, a fully masked row, 8 heads
    at d=32 (the fusion encoder) and d=64 (the ViTDet global blocks; packed
    two heads a 128-lane group on the TPU), and the LSE. A fully masked row
    returns 0 with lse -1e9, as the Pallas finalize does (acc / max(l,
    1e-30) with every block skipped)."""
    q, k, v, bias = _sdpa_inputs(d=d)
    fwd = jfa._flash_fwd_packed if packed else jfa._flash_fwd
    want_o, want_lse = fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                           1.0 / np.sqrt(d), 32, 64, True, return_lse=True)
    got_o, got_lse = fa.flash_sdpa_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bias),
        return_lse=True)
    _assert_close(got_o, want_o)
    _assert_close(got_lse, want_lse)
    assert np.all(got_o[1].numpy() == 0.0)
    assert np.all(got_lse[1].numpy() == jfa.NEG_INF)


def test_flash_sdpa_wrapper_on_cpu_is_the_plain_version():
    q, k, v, bias = _sdpa_inputs(b=1, h=8, lq=48, lk=80)
    want = jfa.flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                          block_q=32, block_k=32, interpret=True)
    before = fa.flash_sdpa.launches
    got = fa.flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert fa.flash_sdpa.launches == before  # no kernel launched for CPU tensors
    _assert_close(got, want)


def _xattn_inputs(b=1, h=2, lq=21, hy=6, wx=10, d=32):
    lk = hy * wx
    return (_randn(b, h, lq, d), _randn(b, h, lk, d), _randn(b, h, lk, d),
            _randn(b, h, lq, hy), _randn(b, h, lq, wx), (hy, wx))


def test_flash_xattn_rpb_plain_matches_pallas_and_einsum():
    """Non-square (h, w) map; kv blocks of 32 over 60 keys, so the last
    block is ragged. The port's kernel adds the exact f32 bias ey + ex, the
    einsum path's choice; with f32 inputs the Pallas one-hot bias matmuls
    are exact too, so all three agree to fp32 rounding."""
    q, k, v, ey, ex, hw = _xattn_inputs()
    want_kernel = jfa.flash_xattn_rpb(*(jnp.asarray(a) for a in (q, k, v, ey, ex)), hw,
                                      block_k=32, interpret=True)
    full = (ey[..., :, None] + ex[..., None, :]).reshape(*ey.shape[:3], hw[0] * hw[1])
    want_einsum = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           bias=jnp.asarray(full))
    got = fa.flash_xattn_rpb(*(torch.from_numpy(a) for a in (q, k, v, ey, ex)), hw)
    _assert_close(got, want_kernel)
    _assert_close(got, want_einsum)


@pytest.mark.parametrize("x_dtype,out_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
])
def test_layer_norm_plain_matches_pallas(x_dtype, out_dtype):
    """fp32 statistics, biased variance, eps inside the sqrt; 300 rows (not
    a multiple of the Pallas 256-row block). With a bf16 output both sides
    round the same fp32 value, so they agree to one bf16 ulp (2^-8)."""
    x = _randn(3, 100, 256)
    w = 1.0 + 0.1 * _randn(256)
    bias = 0.1 * _randn(256)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    want = jax_layer_norm(jx, jnp.asarray(w), jnp.asarray(bias), 1e-5, getattr(jnp, out_dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    got = ln.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(bias), 1e-5,
                        getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    tol = TOL if out_dtype == "float32" else 2.0 ** -8
    _assert_close(got.float(), np.asarray(want.astype(jnp.float32)), tol)
