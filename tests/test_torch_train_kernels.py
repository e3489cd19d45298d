"""The plain versions of the port's backward kernels against ``jax.grad``
through the JAX package's Pallas kernels in interpret mode (as
tests/test_flash_attention.py runs them), on the CPU:

  - ``flash_sdpa_bwd_plain`` (the arithmetic of the dq and dkv kernels,
    csrc/flash_sdpa_bwd_dq_h.cu and csrc/flash_sdpa_bwd_h.cu at head dim 32
    and csrc/flash_sdpa_bwd_wide_h.cu at 256) against the custom VJP of the JAX
    ``flash_sdpa`` (``_flash_bwd``: ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``);
  - ``layer_norm_bwd_plain`` (the arithmetic of csrc/layer_norm.cu's
    backward) against the VJP of the JAX ``layer_norm`` (``_bwd_call`` /
    ``_bwd_kernel``), on row-major rows and on the channel-major batched
    views the backward kernel reads in place;
  - the port's own autograd on CPU tensors, through the plain forwards,
    against the same gradients.

Seeded numpy inputs: ragged lengths, masked 64-key tiles, a batch row with
every key masked, fp32 and bf16.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.ops.pallas import flash_attention as jfa
from efficientsam3_tpu.ops.pallas.flash_attention import flash_sdpa as jflash_sdpa
from efficientsam3_tpu.ops.pallas.layer_norm import layer_norm as jlayer_norm
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.ops import layer_norm as ln

NEG_INF = fa.NEG_INF
# fp32: sums over a few hundred keys in other orders, 1e-5 of each
# gradient's range; bf16: P and dS are rounded to bf16 at the same points
# on both sides, but O (hence Delta) and the sums' order differ, 2e-2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def attention_inputs(dtype, b=3, h=4, lq=70, lk=200, d=32, seed=0):
    """q/k/v/dO as numpy (rounded to dtype), a key bias masking one 64-key
    tile of row 0, the ragged tail of row 1 and every key of row 2."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.array(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))

    q, k, v = rand(b, h, lq, d), rand(b, h, lk, d), rand(b, h, lk, d)
    do = rand(b, h, lq, d)
    bias = np.zeros((b, lk), np.float32)
    bias[0, 64:128] = NEG_INF
    bias[1, lk - 37:] = NEG_INF
    bias[2] = NEG_INF
    return q, k, v, bias, do


def jax_grads(q, k, v, bias, do, dtype):
    cast = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jflash_sdpa(q_, k_, v_, jnp.asarray(bias), block_q=32, block_k=64,
                                       interpret=True), *cast)
    return vjp(jnp.asarray(do, JDT[dtype]))


@pytest.mark.parametrize("dtype,h,d", [
    pytest.param("float32", 4, 32, id="float32"), pytest.param("bfloat16", 4, 32, id="bfloat16"),
    pytest.param("float32", 1, 256, id="float32-d256"),
    pytest.param("bfloat16", 1, 256, id="bfloat16-d256"),
])
def test_flash_sdpa_bwd_plain_matches_jax(dtype, h, d):
    """Head dim 32 (the fusion encoder's 4 heads here) and 256 (the
    tracker's single-head memory attention): against jax.grad through the
    custom VJP and, at d=256, against ``_flash_bwd`` called on the same
    saved output and lse. Ragged Lk (200 over 64-key blocks), a masked key
    tile, a fully masked batch row."""
    q, k, v, bias, do = attention_inputs(dtype, h=h, d=d)
    want = jax_grads(q, k, v, bias, do, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v, do))
    tb = torch.from_numpy(bias)
    o, lse = fa.flash_sdpa_plain(tq, tk, tv, tb, return_lse=True)
    got = fa.flash_sdpa_bwd_plain(tq, tk, tv, tb, o, lse, tdo)
    for g, w in zip(got, want):
        assert g.dtype == TDT[dtype]
        close(g, w, TOL[dtype])
    for g in got:
        assert (g[2] == 0).all()  # every key of batch row 2 masked
    if d == 256:
        jx = [jnp.asarray(np.array(t.float().numpy()), JDT[dtype]) for t in (tq, tk, tv, o, tdo)]
        direct = jfa._flash_bwd(jx[0], jx[1], jx[2], jnp.asarray(bias), jx[3],
                                jnp.asarray(lse.numpy()), jx[4], d ** -0.5, 32, 64, True)
        for g, w in zip(got, direct):
            close(g, w.astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_sdpa_cpu_autograd_matches_jax(dtype):
    """On CPU tensors flash_sdpa is its plain version, which autograd
    differentiates; the JAX custom VJP gives the same gradients."""
    q, k, v, bias, do = attention_inputs(dtype, seed=1)
    want = jax_grads(q, k, v, bias, do, dtype)
    leaves = [torch.from_numpy(x).to(TDT[dtype]).requires_grad_() for x in (q, k, v)]
    out = fa.flash_sdpa(*leaves, torch.from_numpy(bias))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(TDT[dtype]))
    for g, w in zip(got, want):
        close(g, w, TOL[dtype])


@pytest.mark.parametrize("x_dtype,out_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
])
@pytest.mark.parametrize("rows", [37, 300])
def test_layer_norm_bwd_plain_and_autograd_match_jax(x_dtype, out_dtype, rows):
    """dx in x's dtype, dw/db fp32: layer_norm_bwd_plain and the port's CPU
    autograd against jax.grad through the Pallas layer_norm (interpret
    mode, rows padded to its 256-row blocks)."""
    rng = np.random.default_rng(rows)
    x = np.array(jnp.asarray(3 * rng.standard_normal((rows, 256)), JDT[x_dtype])
                   .astype(jnp.float32))
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    g = np.array(jnp.asarray(rng.standard_normal((rows, 256)), JDT[out_dtype])
                   .astype(jnp.float32))
    _, vjp = jax.vjp(lambda x_, w_, b_: jlayer_norm(x_, w_, b_, 1e-5, jnp.dtype(JDT[out_dtype])),
                     jnp.asarray(x, JDT[x_dtype]), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(g, JDT[out_dtype]))
    tx = torch.from_numpy(x).to(TDT[x_dtype])
    tg = torch.from_numpy(g).to(TDT[out_dtype])
    tol = TOL[x_dtype] if x_dtype == out_dtype == "float32" else TOL["bfloat16"]
    plain = ln.layer_norm_bwd_plain(tx, torch.from_numpy(w), tg, 1e-5)
    assert plain[0].dtype == TDT[x_dtype]
    leaves = [tx.clone().requires_grad_(), torch.from_numpy(w).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    auto = torch.autograd.grad(ln.layer_norm(*leaves, 1e-5, TDT[out_dtype]), leaves, tg)
    for got in (plain, auto):
        for a, e in zip(got, want):
            close(a, e, tol)


@pytest.mark.parametrize("x_dtype,g_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
@pytest.mark.parametrize("layout", ["cmajor", "mixed"])
def test_layer_norm_bwd_plain_on_channel_major_views_matches_jax(x_dtype, g_dtype, layout):
    """The backward kernel reads x and dy where they lie: a batch of two
    channel-major maps ((2, C, N) transposed to (2, N, C): no single row
    axis describes it), dy channel-major too or row-major. The plain
    version on those views against the JAX VJP on the same values,
    contiguous; the (batch, row, column) strides the wrapper hands the
    kernel name every element where it lies."""
    rng = np.random.default_rng(5)
    b, n, c = 2, 45, 256

    def rand(dtype, scale):
        a = (scale * rng.standard_normal((b, n, c))).astype(np.float32)
        return np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))

    x, g = rand(x_dtype, 3.0), rand(g_dtype, 1.0)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = np.zeros(c, np.float32)
    _, vjp = jax.vjp(lambda x_, w_, b_: jlayer_norm(x_, w_, b_, 1e-5, jnp.dtype(JDT[g_dtype])),
                     jnp.asarray(x, JDT[x_dtype]), jnp.asarray(w), jnp.asarray(bias))
    want = vjp(jnp.asarray(g, JDT[g_dtype]))

    def cmajor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).to(
            TDT[dtype]).transpose(1, 2)

    tx = cmajor(x, x_dtype)
    tg = cmajor(g, g_dtype) if layout == "cmajor" else torch.from_numpy(g).to(TDT[g_dtype])
    assert not tx.is_contiguous()
    nb, n_, sx, sg, x2, g2 = ln._batch_rows(tx, tg)
    assert (nb, n_) == (b, n) and x2.data_ptr() == tx.data_ptr() and g2.data_ptr() == tg.data_ptr()
    for t, st in ((tx, sx), (tg, sg)):
        torch.testing.assert_close(torch.as_strided(t, (nb, n_, c), st), t)
    got = ln.layer_norm_bwd_plain(tx, torch.from_numpy(w), tg, 1e-5)
    tol = TOL[x_dtype] if x_dtype == g_dtype == "float32" else TOL["bfloat16"]
    for a, e in zip(got, want[:1] + tuple(np.asarray(v) for v in want[1:])):
        close(a, np.asarray(e).reshape(a.shape), tol)
