"""Row LayerNorm: a CUDA forward kernel and a Triton backward kernel, their
plain versions for CPU.

Replaces the Pallas kernels ``efficientsam3_tpu/ops/pallas/layer_norm.py``
(``_fwd_call`` / ``_fwd_kernel`` and ``_bwd_call`` / ``_bwd_kernel``): y =
(x - mean) / sqrt(var + eps) * w + b over the last axis, fp32 statistics,
biased (two-pass) variance, eps inside the sqrt, output in the dtype the
caller asks for (bf16 on the grounding path, so the consumer projections
read half the bytes).

On the H100 both are bound by bytes: the forward reads x and writes y, the
backward reads x and dy and writes dx, ~5-15 flops per element. The forward
is ``csrc/layer_norm.cu`` (see its notes): one row a warp in registers, 16
bytes a lane a load, W and B in registers for every row a warp walks, and
the next row's load in flight under the current row's reductions; a
channel-major map seen as (rows, c) (the fusion encoder's tokens) is read
in place, a tile of rows at a time, not copied first. The
backward recomputes the statistics from x, as the JAX VJP does (the forward
saves no per-row residual), and computes dx = rstd * (wg - mean(wg) - xhat
* mean(wg * xhat)) with wg = dy * w; one program walks ``_BWD_ROWS`` rows
and keeps its partial column sums of dy * xhat and dy in registers, written
once per program to an fp32 buffer that one reduction sums into dw and db
(Triton: a row-wise elementwise pass with two row reductions and no matrix
product).

``layer_norm`` runs as an autograd Function (forward kernel, backward
kernel) on CUDA tensors whenever autograd records the call; its launches
are counted in ``layer_norm.launches`` and the backward's in
``layer_norm_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from efficientsam3_tpu_torch.ops import _build
from efficientsam3_tpu_torch.ops._build import BUILD_DIR
from efficientsam3_tpu_torch.ops._build import needs_grad as _needs_grad


_BWD_ROWS = 32  # rows a backward program walks; its partial sums are one row of the buffer


def layer_norm_plain(x, weight, bias, eps: float = 1e-5, out_dtype=None):
    """The forward kernel's arithmetic in plain PyTorch (fp32 statistics)."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    # keep Triton's compile cache with the other build outputs, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_bwd(X, W, G, DX, DWP, DBP, n_rows, n_cols, stride_x, stride_g, stride_dx, eps,
                ROWS: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inb = cols < n_cols
        w = tl.load(W + cols, mask=inb, other=0.0).to(tl.float32)
        dw = tl.zeros([BLOCK], dtype=tl.float32)
        db = tl.zeros([BLOCK], dtype=tl.float32)
        for i in range(ROWS):
            row = pid * ROWS + i
            m = inb & (row < n_rows)
            x = tl.load(X + row * stride_x + cols, mask=m, other=0.0).to(tl.float32)
            g = tl.load(G + row * stride_g + cols, mask=m, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / n_cols
            xc = tl.where(inb, x - mean, 0.0)
            var = tl.sum(xc * xc, axis=0) / n_cols
            rstd = 1.0 / tl.sqrt(var + eps)
            xhat = xc * rstd
            wg = g * w
            c1 = tl.sum(wg, axis=0) / n_cols
            c2 = tl.sum(wg * xhat, axis=0) / n_cols
            dx = rstd * (wg - c1 - xhat * c2)
            tl.store(DX + row * stride_dx + cols, dx.to(DX.dtype.element_ty), mask=m)
            dw += g * xhat
            db += g
        tl.store(DWP + pid * n_cols + cols, dw, mask=inb)
        tl.store(DBP + pid * n_cols + cols, db, mask=inb)

    return triton, _ln_bwd


_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p


def _lib_fwd():
    """``layer_norm_fwd`` of csrc/layer_norm.cu: x, w, b, y; rows, c; x's
    row and column strides, y's row stride; x fp32, y fp32; eps; the
    stream."""
    fn = _build.load("layer_norm").layer_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 2 + [_LL] * 3 + [_I] * 2 + [_F, _P]
        fn.restype = _I
    return fn


def _lib_fwd_attrs():
    fn = _build.load("layer_norm").layer_norm_fwd_attrs
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I, _LL, _P]
        fn.restype = _I
    return fn


def kernel_resources(x_dtype, out_dtype, c, col_stride=1):
    """Registers and spilled bytes a thread, the path (16-byte vectors a
    lane on the vector path, 0 the masked path, -1 the column path) and
    resident blocks an SM of the forward kernel that a (rows, c) call of
    x_dtype -> out_dtype takes (x's columns col_stride elements apart), on
    the current device."""
    out = (ctypes.c_int * 4)()
    _build.check(_lib_fwd_attrs()(int(x_dtype == torch.float32), int(out_dtype == torch.float32),
                                  c, col_stride, out), "layer_norm attributes")
    return dict(zip(("registers", "spill_bytes", "path", "blocks_per_sm"), out))


def _row_view(t):
    """t as a (rows, c) view over the same memory when its leading axes
    merge into one row axis (any row and column strides: the column path
    reads a channel-major map in place), else a contiguous copy."""
    c = t.shape[-1]
    lead = [(n, st) for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n != 1]
    if all(lead[i][1] == lead[i + 1][0] * lead[i + 1][1] for i in range(len(lead) - 1)):
        rows = t.numel() // c if c else 0
        return t.as_strided((rows, c), (lead[-1][1] if lead else c, t.stride(-1)))
    return t.reshape(-1, c).contiguous()


def _launch(x2, weight, bias, eps, out_dtype):
    rows, c = x2.shape
    y = torch.empty((rows, c), dtype=out_dtype, device=x2.device)
    if rows == 0:
        return y
    status = _lib_fwd()(
        x2.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, c,
        x2.stride(0), x2.stride(1), y.stride(0), int(x2.dtype == torch.float32),
        int(out_dtype == torch.float32), float(eps),
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(status, "layer_norm launch")
    return y


def _check(x, out_dtype):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel writes float32 or bfloat16, got {out_dtype}")
    if x.shape[-1] > 8192:
        raise ValueError(f"layer_norm kernel keeps one row in registers; {x.shape[-1]} "
                         "channels is too wide")


def _rows(t):
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _layer_norm_fwd(x, weight, bias, eps, out_dtype):
    x2 = _row_view(x)
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        y = _launch(x2, w, b, eps, out_dtype)
    layer_norm.launches += 1
    return y.reshape(x.shape)


def layer_norm_bwd_plain(x, weight, g, eps: float = 1e-5):
    """The backward kernel's arithmetic: (dx in x.dtype, dw, db fp32), the
    statistics recomputed from x."""
    xf = x.float()
    gf = g.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    wg = gf * weight.float()
    c1 = wg.mean(-1, keepdim=True)
    c2 = (wg * xhat).mean(-1, keepdim=True)
    dx = rstd * (wg - c1 - xhat * c2)
    c = x.shape[-1]
    return (dx.to(x.dtype), (gf * xhat).reshape(-1, c).sum(0),
            gf.reshape(-1, c).sum(0))


def layer_norm_bwd(x, weight, g, eps: float = 1e-5):
    """Gradients of layer_norm from its input and the output gradient g:
    (dx in x.dtype, dw, db fp32). One Triton launch on CUDA (counted in
    ``layer_norm_bwd.launches``) writes dx and per-program partial column
    sums; one reduction sums those. The plain version for CPU tensors."""
    if not x.is_cuda:
        return layer_norm_bwd_plain(x, weight, g, eps)
    _check(x, g.dtype)
    if g.shape != x.shape:
        raise ValueError(f"layer_norm backward: g {tuple(g.shape)} for x {tuple(x.shape)}")
    x2, g2 = _rows(x), _rows(g)
    rows, c = x2.shape
    nprog = -(-rows // _BWD_ROWS)
    dx = torch.empty((rows, c), dtype=x.dtype, device=x.device)
    partial = torch.empty((2, nprog, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # Triton launches on the current device
        triton, kernel = _triton_kernel()
        block = triton.next_power_of_2(c)
        kernel[(nprog,)](
            x2, weight.float().contiguous(), g2, dx, partial[0], partial[1], rows, c,
            x2.stride(0), g2.stride(0), dx.stride(0), float(eps),
            ROWS=_BWD_ROWS, BLOCK=block, num_warps=max(1, min(8, block // 256)),
        )
    layer_norm_bwd.launches += 1
    dwb = partial.sum(1)
    return dx.reshape(x.shape), dwb[0], dwb[1]


layer_norm_bwd.launches = 0


class _LayerNormFn(torch.autograd.Function):
    """layer_norm under autograd on CUDA: saves x and weight and recomputes
    the statistics in the backward kernel (the JAX ``_vjp_fwd`` /
    ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _layer_norm_fwd(x, weight, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None, None


def layer_norm(x, weight, bias, eps: float = 1e-5, out_dtype=None):
    """LayerNorm over the last axis of x (any leading rank).

    CPU tensors take the plain version; CUDA tensors launch the forward
    kernel (x in fp32 or bf16, output in ``out_dtype``, default x.dtype),
    through ``_LayerNormFn`` when autograd records the call.
    """
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps, out_dtype)
    _check(x, out_dtype)
    if _needs_grad(x, weight, bias):
        return _LayerNormFn.apply(x, weight, bias, eps, out_dtype)
    return _layer_norm_fwd(x, weight, bias, eps, out_dtype)


layer_norm.launches = 0
