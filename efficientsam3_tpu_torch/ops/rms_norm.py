"""Channel RMSNorm over NHWC maps: Triton kernels (forward and backward)
for CUDA, their plain versions for CPU.

Replaces the Pallas kernels ``efficientsam3_tpu/ops/pallas/rms_norm.py``
(``_fwd_call`` / ``_fwd_kernel`` and ``_bwd_call`` / ``_bwd_kernel``), the
TPU counterpart of the reference's fused Triton RMSNorm for the
EfficientViT variants that normalise with ``norm='rms2d'``: over the last
(channel) axis, out = x * rstd * w + b with rstd = 1 / sqrt(mean(x^2) +
eps) in fp32, out in x's dtype. The backward takes the forward's saved
rstd: dx = rstd * (w g - xhat * mean(w g xhat)) with xhat = x * rstd, and
dw = sum(g xhat), db = sum(g) summed in fp32 per program, then in one
final sum over the programs.

On the H100 both are bound by bytes: the forward reads x and writes out
(and 4 bytes of rstd a row), the backward reads x, g and rstd and writes
dx, ~6-10 flops per element. A program owns ``_ROWS`` whole rows as one
(rows, C) tile in registers, so each element is read once and the row
reductions run over the loaded tile; the ragged last tile is masked in the
kernel (no padding copy, unlike the JAX wrapper's pad to 256-row blocks).
Triton rather than CUDA: two row reductions fused with elementwise work,
no matrix product.

No model of the JAX package calls ``rms_norm_2d`` (EfficientViT's norm
switch handles only 'bn2d'), so it is ported at kernel level. Under
autograd on CUDA it runs as ``_RmsNorm2dFn``; launches are counted in
``rms_norm_2d.launches`` and ``rms_norm_2d_bwd.launches``. CPU tensors
take the plain version, which autograd differentiates; CUDA tensors in a
dtype other than fp32 or bf16 raise.
"""

from __future__ import annotations

import functools
import os

import torch

from efficientsam3_tpu_torch.ops._build import BUILD_DIR
from efficientsam3_tpu_torch.ops._build import needs_grad as _needs_grad

_ROWS = 16  # rows a program owns, forward and backward


def _rstd(xf, eps):
    return torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)


def rms_norm_2d_plain(x, weight, bias, eps: float = 1e-5, return_rstd: bool = False):
    """The forward kernel's arithmetic: (out in x.dtype, rstd (rows,) fp32
    with return_rstd), rows = every axis but the last."""
    xf = x.float()
    rstd = _rstd(xf, eps)
    out = (xf * rstd * weight.float() + bias.float()).to(x.dtype)
    return (out, rstd.reshape(-1)) if return_rstd else out


def rms_norm_2d_bwd_plain(x, weight, rstd, g):
    """The backward kernel's arithmetic (JAX ``_bwd_kernel`` and its final
    sum): (dx in x.dtype, dw, db fp32) from the saved rstd (rows,)."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    gf = g.float().reshape(-1, c)
    r = rstd.float().reshape(-1, 1)
    xhat = xf * r
    wg = gf * weight.float()
    dx = r * (wg - xhat * (wg * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype).reshape(x.shape), (gf * xhat).sum(0), gf.sum(0)


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    # keep Triton's compile cache with the other build outputs, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _rms_fwd(X, W, B, Y, RSTD, n_rows, n_cols, eps,
                 ROWS: tl.constexpr, BLOCK: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK)
        rin = rows < n_rows
        cin = cols < n_cols
        m = rin[:, None] & cin[None, :]
        offs = rows[:, None].to(tl.int64) * n_cols + cols[None, :]
        x = tl.load(X + offs, mask=m, other=0.0).to(tl.float32)
        rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / n_cols + eps)
        w = tl.load(W + cols, mask=cin, other=0.0).to(tl.float32)
        b = tl.load(B + cols, mask=cin, other=0.0).to(tl.float32)
        y = x * rstd[:, None] * w[None, :] + b[None, :]
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=m)
        tl.store(RSTD + rows, rstd, mask=rin)

    @triton.jit
    def _rms_bwd(X, W, RSTD, G, DX, DWP, DBP, n_rows, n_cols,
                 ROWS: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK)
        rin = rows < n_rows
        cin = cols < n_cols
        m = rin[:, None] & cin[None, :]
        offs = rows[:, None].to(tl.int64) * n_cols + cols[None, :]
        x = tl.load(X + offs, mask=m, other=0.0).to(tl.float32)
        g = tl.load(G + offs, mask=m, other=0.0).to(tl.float32)
        r = tl.load(RSTD + rows, mask=rin, other=0.0)
        w = tl.load(W + cols, mask=cin, other=0.0).to(tl.float32)
        xhat = x * r[:, None]
        wg = g * w[None, :]
        c = tl.sum(wg * xhat, axis=1) / n_cols
        dx = r[:, None] * (wg - xhat * c[:, None])
        tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=m)
        tl.store(DWP + pid * n_cols + cols, tl.sum(g * xhat, axis=0), mask=cin)
        tl.store(DBP + pid * n_cols + cols, tl.sum(g, axis=0), mask=cin)

    return triton, _rms_fwd, _rms_bwd


def _check(x, what):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {x.dtype}")
    if x.shape[-1] > 4096:
        raise ValueError(f"{what} kernel keeps {_ROWS} rows in registers; {x.shape[-1]} "
                         "channels is too wide")


def _warps(block):
    return max(1, min(8, _ROWS * block // 1024))


def _fwd(x, weight, bias, eps):
    """One forward launch: (out in x.dtype, rstd (rows,) fp32)."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    rows = x2.shape[0]
    y = torch.empty_like(x2)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # Triton launches on the current device
        triton, kernel, _ = _triton_kernels()
        block = triton.next_power_of_2(c)
        kernel[(triton.cdiv(rows, _ROWS),)](
            x2, weight.float().contiguous(), bias.float().contiguous(), y, rstd, rows, c,
            float(eps), ROWS=_ROWS, BLOCK=block, num_warps=_warps(block))
    rms_norm_2d.launches += 1
    return y.reshape(x.shape), rstd


def rms_norm_2d_bwd(x, weight, rstd, g):
    """Gradients of rms_norm_2d from its input, weight, saved rstd (rows,)
    and the output gradient g: (dx in x.dtype, dw, db fp32). One Triton
    launch on CUDA (counted in ``rms_norm_2d_bwd.launches``) writes dx and
    per-program fp32 partial column sums; one sum finishes dw and db. The
    plain version for CPU tensors."""
    if not x.is_cuda:
        return rms_norm_2d_bwd_plain(x, weight, rstd, g)
    _check(x, "rms_norm_2d backward")
    _check(g, "rms_norm_2d backward")
    if g.shape != x.shape:
        raise ValueError(f"rms_norm_2d backward: g {tuple(g.shape)} for x {tuple(x.shape)}")
    c = x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    g2 = g.reshape(-1, c).contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    with torch.cuda.device(x.device):  # Triton launches on the current device
        triton, _, kernel = _triton_kernels()
        nprog = triton.cdiv(rows, _ROWS)
        partial = torch.empty((2, nprog, c), dtype=torch.float32, device=x.device)
        block = triton.next_power_of_2(c)
        kernel[(nprog,)](
            x2, weight.float().contiguous(), rstd.float().contiguous(), g2, dx, partial[0],
            partial[1], rows, c, ROWS=_ROWS, BLOCK=block, num_warps=_warps(block))
    rms_norm_2d_bwd.launches += 1
    dwb = partial.sum(1)
    return dx.reshape(x.shape), dwb[0], dwb[1]


rms_norm_2d_bwd.launches = 0


class _RmsNorm2dFn(torch.autograd.Function):
    """rms_norm_2d under autograd on CUDA: the forward kernel saves rstd,
    the backward kernel reads it (the JAX ``_vjp_fwd`` / ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        out, rstd = _fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, rstd)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw, db = rms_norm_2d_bwd(x, weight, rstd, g)
        return dx, dw.to(weight.dtype), db.to(ctx.bias_dtype), None


def rms_norm_2d(x, weight, bias, eps: float = 1e-5):
    """RMSNorm over the last axis of x (NHWC maps or any leading rank), with
    an affine weight and bias; the result in x.dtype.

    CPU tensors take the plain version; CUDA tensors (fp32 or bf16) launch
    the Triton kernel, through ``_RmsNorm2dFn`` when autograd records the
    call."""
    if not x.is_cuda:
        return rms_norm_2d_plain(x, weight, bias, eps)
    _check(x, "rms_norm_2d")
    if _needs_grad(x, weight, bias):
        return _RmsNorm2dFn.apply(x, weight, bias, eps)
    return _fwd(x, weight, bias, eps)[0]


rms_norm_2d.launches = 0
