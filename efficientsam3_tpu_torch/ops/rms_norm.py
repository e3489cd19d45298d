"""Channel RMSNorm over NHWC maps: a Triton forward and a CUDA backward
for CUDA, their plain versions for CPU.

Replaces the Pallas kernels ``efficientsam3_tpu/ops/pallas/rms_norm.py``
(``_fwd_call`` / ``_fwd_kernel`` and ``_bwd_call`` / ``_bwd_kernel``), the
TPU counterpart of the reference's fused Triton RMSNorm for the
EfficientViT variants that normalise with ``norm='rms2d'``: over the last
(channel) axis, out = x * rstd * w + b with rstd = 1 / sqrt(mean(x^2) +
eps) in fp32, out in x's dtype. The backward takes the forward's saved
rstd: dx = rstd * (w g - xhat * mean(w g xhat)) with xhat = x * rstd, and
dw = sum(g xhat), db = sum(g) summed in fp32.

On the H100 both are bound by bytes: the forward reads x and writes out
(and 4 bytes of rstd a row), the backward reads x, g and rstd and writes
dx, ~6-10 flops per element. The forward (Triton) has a program own
``_ROWS`` whole rows as one (rows, C) tile in registers, so each element is
read once and the row reductions run over the loaded tile; the ragged last
tile is masked in the kernel (no padding copy, unlike the JAX wrapper's pad
to 256-row blocks). The backward is a mode of LayerNorm's backward kernel
(``csrc/layer_norm.cu``, ``rms_norm_bwd``): a row a warp with the next rows'
loads in flight, each lane's dw / db column sums in registers, the blocks'
sums finished in the same launch by atomic tickets in a fixed order (the
same bits on every run). One launch writes dx, dw and db.

No model of the JAX package calls ``rms_norm_2d`` (EfficientViT's norm
switch handles only 'bn2d'), so it is ported at kernel level. Under
autograd on CUDA it runs as ``_RmsNorm2dFn``; launches are counted in
``rms_norm_2d.launches`` and ``rms_norm_2d_bwd.launches``. CPU tensors
take the plain version, which autograd differentiates; CUDA tensors in a
dtype other than fp32 or bf16 raise.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from efficientsam3_tpu_torch.ops import _build
from efficientsam3_tpu_torch.ops import layer_norm as _ln
from efficientsam3_tpu_torch.ops._build import BUILD_DIR
from efficientsam3_tpu_torch.ops._build import needs_grad as _needs_grad

_ROWS = 16  # rows a program of the forward owns
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


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

    return triton, _rms_fwd


def _check(x, what):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {x.dtype}")
    if x.shape[-1] > 4096:  # the forward keeps _ROWS whole rows in registers
        raise ValueError(f"{what} kernel takes at most 4096 channels; {x.shape[-1]} is too wide")


def _lib_bwd():
    """``rms_norm_bwd`` of csrc/layer_norm.cu: x, dy, w, rstd, dx, dw, db,
    the scratch and its rows, the tickets and their count; rows, c; x fp32,
    dy fp32; the stream."""
    fn = _build.load("layer_norm").rms_norm_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_LL, _P] + [_I] * 5 + [_P]
        fn.restype = _I
    return fn


def _lib_bwd_attrs():
    fn = _build.load("layer_norm").rms_norm_bwd_attrs
    if fn.argtypes is None:
        fn.argtypes = [_I] * 3 + [_P]
        fn.restype = _I
    return fn


def bwd_kernel_resources(x_dtype, g_dtype, c):
    """Registers and spilled bytes a thread, the path (16-byte vectors a
    lane on the vector path, 0 the masked path) and resident blocks an SM
    of the backward kernel that (rows, c) x_dtype maps and g_dtype output
    gradients take, on the current device."""
    out = (ctypes.c_int * 4)()
    _build.check(_lib_bwd_attrs()(int(x_dtype == torch.float32), int(g_dtype == torch.float32),
                                  c, out), "rms_norm_bwd attributes")
    return dict(zip(("registers", "spill_bytes", "path", "blocks_per_sm"), out))


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
        triton, kernel = _triton_kernels()
        block = triton.next_power_of_2(c)
        kernel[(triton.cdiv(rows, _ROWS),)](
            x2, weight.float().contiguous(), bias.float().contiguous(), y, rstd, rows, c,
            float(eps), ROWS=_ROWS, BLOCK=block, num_warps=_warps(block))
    rms_norm_2d.launches += 1
    return y.reshape(x.shape), rstd


def rms_norm_2d_bwd(x, weight, rstd, g):
    """Gradients of rms_norm_2d from its input, weight, saved rstd (rows,)
    and the output gradient g: (dx in x.dtype, dw, db fp32). One CUDA
    launch writes all three (counted in ``rms_norm_2d_bwd.launches``); the
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
    if rstd.numel() != rows:
        raise ValueError(f"rms_norm_2d backward: rstd of {rstd.numel()} rows for {rows}")
    dx = torch.empty_like(x2)
    if dx.numel() == 0:  # no element: the sums are 0
        zero = torch.zeros(c, device=x.device)
        return dx.reshape(x.shape), zero, zero.clone()
    dwb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    most = _ln.BWD_BLOCKS_PER_SM * _ln._sms(x.device.index)  # resident blocks at most
    _, _, groups = _ln.bwd_grid(1, most, "masked", most)  # the finish's groups at most
    part = torch.empty((most + groups, 2 * c), dtype=torch.float32, device=x.device)
    w = weight.float().contiguous()
    r = rstd.float().contiguous()
    tickets = _build.tickets(x.device, groups + 1)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib_bwd()(
            x2.data_ptr(), g2.data_ptr(), w.data_ptr(), r.data_ptr(), dx.data_ptr(),
            dwb[0].data_ptr(), dwb[1].data_ptr(), part.data_ptr(), most + groups,
            tickets.data_ptr(), groups + 1, rows, c, int(x.dtype == torch.float32),
            int(g.dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "rms_norm_2d backward launch")
    rms_norm_2d_bwd.launches += 1
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
    the Triton forward, through ``_RmsNorm2dFn`` (and the CUDA backward)
    when autograd records the call."""
    if not x.is_cuda:
        return rms_norm_2d_plain(x, weight, bias, eps)
    _check(x, "rms_norm_2d")
    if _needs_grad(x, weight, bias):
        return _RmsNorm2dFn.apply(x, weight, bias, eps)
    return _fwd(x, weight, bias, eps)[0]


rms_norm_2d.launches = 0
