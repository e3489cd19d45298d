"""Row LayerNorm: CUDA forward and backward kernels, their plain versions
for CPU.

Replaces the Pallas kernels ``efficientsam3_tpu/ops/pallas/layer_norm.py``
(``_fwd_call`` / ``_fwd_kernel`` and ``_bwd_call`` / ``_bwd_kernel``): y =
(x - mean) / sqrt(var + eps) * w + b over the last axis, fp32 statistics,
biased (two-pass) variance, eps inside the sqrt, output in the dtype the
caller asks for (bf16 on the grounding path, so the consumer projections
read half the bytes).

On the H100 both are bound by bytes: the forward reads x and writes y, the
backward reads x and dy and writes dx, ~5-15 flops per element. Both are
``csrc/layer_norm.cu`` (see its notes): one row a warp in registers, 16
bytes a lane a load, W (and B) in registers for every row a warp walks,
and the next row's loads in flight under the current row's reductions; a
channel-major map seen as (rows, c) (the fusion encoder's tokens) is read
in place, a tile of rows at a time, not copied first. The backward
recomputes the statistics from x, as the JAX VJP does (the forward saves
no per-row residual), and computes dx = rstd * (wg - mean(wg) - xhat *
mean(wg * xhat)) with wg = dy * w; a lane keeps its columns' sums of dy *
xhat and dy in registers, the block adds its warps' into one row, and the
blocks' rows are summed into dw and db in the same launch, in a fixed
order. It reads x and dy at their strides as (batch, rows, c) views, so a
batch of channel-major maps (whose axes merge into no single row axis) is
not copied either.

``layer_norm`` runs as an autograd Function (forward kernel, backward
kernel) on CUDA tensors whenever autograd records the call; its launches
are counted in ``layer_norm.launches`` and the backward's in
``layer_norm_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from efficientsam3_tpu_torch.ops import _build
from efficientsam3_tpu_torch.ops._build import needs_grad as _needs_grad

BWD_TILE = 16  # rows a tile of the backward's column path
BWD_WARPS = 16  # warps a block of the backward
BWD_BLOCKS_PER_SM = 4  # at most: 512 threads a block


def layer_norm_plain(x, weight, bias, eps: float = 1e-5, out_dtype=None):
    """The forward kernel's arithmetic in plain PyTorch (fp32 statistics)."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(out_dtype)


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


def _lib_bwd():
    """``layer_norm_bwd`` of csrc/layer_norm.cu: x, dy, w, dx, dw, db, the
    scratch and its rows, the tickets and their count; nb, n, c; x's and
    dy's batch, row and column strides; x fp32, dy fp32; eps; the
    stream."""
    fn = _build.load("layer_norm").layer_norm_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_LL, _P] + [_I] * 4 + [_LL] * 6 + [_I] * 2 + [_F, _P]
        fn.restype = _I
    return fn


def _lib_bwd_attrs():
    fn = _build.load("layer_norm").layer_norm_bwd_attrs
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


def bwd_kernel_resources(x_dtype, g_dtype, c, col_stride=1):
    """As ``kernel_resources``, for the backward kernel that x_dtype maps
    and g_dtype output gradients of c columns take (row-major, or with
    col_stride != 1 channel-major)."""
    out = (ctypes.c_int * 4)()
    _build.check(_lib_bwd_attrs()(int(x_dtype == torch.float32), int(g_dtype == torch.float32),
                                  c, col_stride, out), "layer_norm_bwd attributes")
    return dict(zip(("registers", "spill_bytes", "path", "blocks_per_sm"), out))


def bwd_grid(nb, n, path, resident):
    """The backward kernel's grid for nb x n rows on ``path`` ("vector": a
    row a warp; "column": a tile of BWD_TILE rows of one image; "masked": a
    row a block), persistent blocks, the resident ones at most (the
    kernel's rule); and its finish's blocks a group and groups."""
    work = {"vector": -(-nb * n // BWD_WARPS), "column": nb * -(-n // BWD_TILE),
            "masked": nb * n}[path]
    grid = min(resident, work)
    gsize = math.isqrt(grid - 1) + 1 if grid > 1 else 1
    return grid, gsize, -(-grid // gsize)


@functools.lru_cache(maxsize=None)
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _groups3(t):
    """The leading axes of t (size 1 dropped) merged where their strides
    allow: [(size, stride), ...] outermost first."""
    out = []
    for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
        if size == 1:
            continue
        if out and out[-1][1] == size * stride:
            out[-1] = (out[-1][0] * size, stride)
        else:
            out.append((size, stride))
    return out


def _batch_rows(x, g):
    """(nb, n) and x's and g's (batch, row, column) strides describing both
    in place, with the tensors to launch on: a layout no two axes describe
    (or one that splits its rows otherwise than x's) is made contiguous
    first."""
    gx, gg = _groups3(x), _groups3(g)
    if len(gx) > 2:
        x = x.contiguous()
        gx = _groups3(x)
    if len(gg) > 2 or (len(gx) == 2 == len(gg) and gx[0][0] != gg[0][0]):
        g = g.contiguous()
        gg = _groups3(g)
    split = gx if len(gx) == 2 else gg if len(gg) == 2 else None
    nb, n = (split[0][0], split[1][0]) if split else (1, x.numel() // x.shape[-1])

    def strides(groups, t):
        if len(groups) == 2:
            return groups[0][1], groups[1][1], t.stride(-1)
        row = groups[0][1] if groups else 0
        return n * row, row, t.stride(-1)

    return nb, n, strides(gx, x), strides(gg, g), x, g


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
    (dx in x.dtype, dw, db fp32). One CUDA launch (counted in
    ``layer_norm_bwd.launches``) writes all three, reading x and g in place
    (row-major or channel-major, batched); the plain version for CPU
    tensors."""
    if not x.is_cuda:
        return layer_norm_bwd_plain(x, weight, g, eps)
    _check(x, g.dtype)
    if g.shape != x.shape:
        raise ValueError(f"layer_norm backward: g {tuple(g.shape)} for x {tuple(x.shape)}")
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    dx = torch.empty((rows, c), dtype=x.dtype, device=x.device)
    if dx.numel() == 0:  # no element: the sums are 0
        zero = torch.zeros(c, device=x.device)
        return dx.reshape(x.shape), zero, zero.clone()
    nb, n, sx, sg, x, g = _batch_rows(x, g)
    dwb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    most = BWD_BLOCKS_PER_SM * _sms(x.device.index)  # resident blocks at most
    _, _, groups = bwd_grid(1, most, "masked", most)  # the finish's groups at most
    part = torch.empty((most + groups, 2 * c), dtype=torch.float32, device=x.device)
    w = weight.float().contiguous()
    tickets = _build.tickets(x.device, groups + 1)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib_bwd()(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), dx.data_ptr(),
            dwb[0].data_ptr(), dwb[1].data_ptr(), part.data_ptr(), most + groups,
            tickets.data_ptr(), groups + 1, nb, n, c, *sx, *sg,
            int(x.dtype == torch.float32), int(g.dtype == torch.float32), float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "layer_norm_bwd launch")
    layer_norm_bwd.launches += 1
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
