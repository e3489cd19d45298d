"""The plain versions of the kernels on the tracker's training path against
the JAX package's Pallas kernels in interpret mode, on the CPU:

  - ``depthwise_conv2d_bwd_plain`` (the arithmetic of the dx launch of
    csrc/depthwise_conv2d.cu and of the fp32 dw / db reductions) against
    the JAX ``_dw_bwd``, and the port's autograd against ``jax.grad`` of
    ``depthwise_conv2d(interpret=True)``;
  - ``rms_norm_2d_plain`` / ``rms_norm_2d_bwd_plain`` (the Triton kernels'
    arithmetic) and the port's autograd against the JAX ``rms_norm_2d``
    (its Pallas kernels run in interpret mode off the TPU), with a row count
    that is not a multiple of its 256-row blocks.

``flash_sdpa_bwd_plain`` at head dim 256 is held against ``_flash_bwd`` and
``jax.grad`` in tests/test_torch_train_kernels.py. Seeded numpy inputs.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.ops.pallas import depthwise as jdw
from efficientsam3_tpu.ops.pallas.rms_norm import rms_norm_2d as jrms_norm_2d
from efficientsam3_tpu_torch.ops import depthwise as dw
from efficientsam3_tpu_torch.ops import rms_norm as rn

# fp32 on both sides; sums over 49 taps, a few thousand pixels or a row of
# channels in other orders: ~1e-6 of each output's range
TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _inputs(shape, seed, k=7):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (0.2 * rng.standard_normal((k, k, 1, c))).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 9, 11, 8), (1, 3, 4, 5)])
def test_depthwise_bwd_plain_matches_jax_vjp(shape):
    """dx (the forward over the flipped taps, zero bias), dw and db against
    the JAX ``_dw_bwd``; odd H / W, and a map smaller than the 7x7 taps."""
    x, wk, bias, g = _inputs(shape, 3)
    want = jdw._dw_bwd(True, (jnp.asarray(x), jnp.asarray(wk)), jnp.asarray(g))
    got = dw.depthwise_conv2d_bwd_plain(*(torch.from_numpy(a) for a in (x, wk, g)))
    assert got[0].dtype == torch.float32 and got[1].shape == (7, 7, 1, shape[-1])
    for a, e in zip(got, want):
        _close(a, e)


def test_depthwise_autograd_matches_jax_grad():
    """The port's depthwise_conv2d under autograd (CPU tensors: the plain
    forward) against jax.grad of the Pallas depthwise_conv2d, whose custom
    VJP is ``_dw_bwd``."""
    x, wk, bias, g = _inputs((2, 10, 7, 16), 4)
    _, vjp = jax.vjp(lambda a, b, c: jdw.depthwise_conv2d(a, b, c, True),
                     *(jnp.asarray(a) for a in (x, wk, bias)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wk, bias)]
    got = torch.autograd.grad(dw.depthwise_conv2d(*leaves), leaves, torch.from_numpy(g))
    for a, e in zip(got, want):
        _close(a, e)


@pytest.mark.parametrize("shape", [(3, 9, 13, 128), (1, 5, 7, 40)])
def test_rms_norm_2d_plain_and_autograd_match_jax(shape):
    """Forward (out, rstd), backward from the saved rstd (dx, dw, db) and
    the port's CPU autograd against the JAX rms_norm_2d and its VJP: 351
    and 35 rows (a ragged last 256-row block in the JAX kernels, no padding
    in the port's)."""
    rng = np.random.default_rng(shape[-1])
    c = shape[-1]
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    want_out, vjp = jax.vjp(lambda a, bw, bb: jrms_norm_2d(a, bw, bb, 1e-5), jx, jw, jb)
    want_grads = vjp(jnp.asarray(g))
    rows = int(np.prod(shape[:-1]))
    want_rstd = 1.0 / np.sqrt((x.reshape(rows, c) ** 2).mean(-1) + 1e-5)
    tx, tw, tb, tg = (torch.from_numpy(a) for a in (x, w, b, g))
    out, rstd = rn.rms_norm_2d_plain(tx, tw, tb, 1e-5, return_rstd=True)
    _close(out, want_out)
    _close(rstd, want_rstd)
    for a, e in zip(rn.rms_norm_2d_bwd_plain(tx, tw, rstd, tg), want_grads):
        _close(a, e)
    leaves = [t.clone().requires_grad_() for t in (tx, tw, tb)]
    auto = torch.autograd.grad(rn.rms_norm_2d(*leaves), leaves, tg)
    for a, e in zip(auto, want_grads):
        _close(a, e)


def test_rms_norm_2d_bf16_rounds_where_jax_does():
    """bf16 maps: out and dx in bf16, rstd and dw / db in fp32, as the JAX
    kernels give them (one bf16 ulp, 2^-7 relative, between the two
    frameworks' rounding of the same fp32 values)."""
    rng = np.random.default_rng(9)
    x = (3 * rng.standard_normal((2, 7, 9, 64))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want_out, vjp = jax.vjp(lambda a, bw, bb: jrms_norm_2d(a, bw, bb, 1e-5), jx,
                            jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    tg = torch.from_numpy(np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32)))
    tg = tg.to(torch.bfloat16)
    out, rstd = rn.rms_norm_2d_plain(tx, torch.from_numpy(w), torch.from_numpy(b),
                                     return_rstd=True)
    grads = rn.rms_norm_2d_bwd_plain(tx, torch.from_numpy(w), rstd, tg)
    assert out.dtype == grads[0].dtype == torch.bfloat16 and rstd.dtype == torch.float32
    _close(out, want_out.astype(jnp.float32), 1e-2)
    for a, e in zip(grads, want):
        _close(a, e.astype(jnp.float32), 1e-2)
