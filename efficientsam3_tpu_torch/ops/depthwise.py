"""Same-padded depthwise 2D convolution over NHWC maps: CUDA kernels for
the H100 and their plain PyTorch versions, forward and backward.

Replaces the Pallas kernel ``efficientsam3_tpu/ops/pallas/depthwise.py``
(``_dw_call`` / ``_dw_kernel``) and its custom VJP (``_dw_bwd``): the 7x7
depthwise conv of the tracker memory encoder's ConvNeXt fuser
(``models/memory_encoder.CXBlock``), fp32 accumulation, bias, output in the
input dtype. The kernels are CUDA C++ in ``csrc/depthwise_conv2d.cu`` (see
its note for what bounds them and how they walk the map), built by
``ops/_build.py`` on first use.

The backward follows ``_dw_bwd``: dx is the same correlation over the
output gradient with the taps flipped on both spatial axes and a zero bias
(a same-padded correlation's adjoint), cast to x's dtype; dw and db, jnp
reductions outside any Pallas kernel in JAX, are fp32 sums, cast to the
taps' and the bias's dtypes. One launch of ``dw7_bwd_kernel`` writes all
three: it stages x and g once, and its blocks' partial sums are finished in
the same launch in a fixed order. Their plain version is the JAX
reductions' arithmetic.

The kernels take any channel count and any map size. The JAX package's
dispatch rule ``use_pallas_depthwise`` (channels a multiple of 128, maps
within the VMEM budget) only existed for the TPU's lanes and fast memory;
here every CXBlock depthwise on a CUDA tensor goes to the kernel. CPU
tensors take the plain version (differentiated by autograd); a CUDA tensor
the kernel does not take (maps other than bf16 or fp32, taps or bias other
than bf16 or fp32, a kernel size other than 7; in the backward an output
gradient of another dtype than x) raises. The taps and bias are read in
place at their strides and dtypes (CXBlock hands in a permuted view of its
conv weight), so a call launches nothing but its kernel. When autograd
records the call on CUDA it runs as ``_DepthwiseConv2dFn``.
``depthwise_conv2d.launches`` counts the forward's launches,
``depthwise_conv2d_bwd.launches`` the backward's.

``walk_runs`` and ``group_blocks`` mirror the kernels' partition of the
work (tests/test_torch_kernel_rules.py holds it on the CPU).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from efficientsam3_tpu_torch.ops import _build

_KERNEL_SIZE = 7
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
CHANNELS_A_BLOCK = 32  # the kernels' channel group: one channel a lane
STRIP = 36  # output columns a strip: 6 warps of 6 columns
PARTS = 50  # a partial row: the 49 tap sums and the bias sum


def depthwise_conv2d_plain(x, kernel, bias):
    """x (B, H, W, C); kernel (k, k, 1, C) in the flax depthwise layout;
    bias (C,). Zero 'same' padding, fp32 sum of the k*k taps, bias added in
    fp32, result in x.dtype."""
    k = kernel.shape[0]
    p = k // 2
    h, w = x.shape[1:3]
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    wk = kernel[:, :, 0, :].float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dj in range(k):
        for di in range(k):
            acc += wk[di, dj] * xp[:, di:di + h, dj:dj + w]
    return (acc + bias.float()).to(x.dtype)


def _dw_db(x, g, k):
    """dw (k, k, 1, C) and db (C,) in fp32: dw[di, dj] = sum over the batch
    and the map of x_padded[.., i + di, j + dj, c] * g[.., i, j, c]."""
    p = k // 2
    h, w = x.shape[1:3]
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    gf = g.float()
    dw = torch.stack([
        torch.stack([(xp[:, di:di + h, dj:dj + w] * gf).sum((0, 1, 2)) for dj in range(k)])
        for di in range(k)
    ])[:, :, None, :]
    return dw, gf.sum((0, 1, 2))


def depthwise_conv2d_bwd_plain(x, kernel, g):
    """The backward's arithmetic (JAX ``_dw_bwd``): (dx in x.dtype, dw, db
    fp32). dx is the forward's plain version over g with the flipped taps
    and a zero bias."""
    zero = torch.zeros(kernel.shape[-1], dtype=torch.float32, device=x.device)
    dx = depthwise_conv2d_plain(g, kernel.flip(0, 1), zero).to(x.dtype)
    return (dx, *_dw_db(x, g, kernel.shape[0]))


def walk_runs(b, h, w, c, grid):
    """The kernels' partition of the work: for each of grid blocks, its runs
    (group, image, strip, i0, i1) in walk order. The runs of every (channel
    group, image, strip), H rows each, laid end to end and cut into one
    equal range of rows a block (csrc/depthwise_conv2d.cu, ``Walk``)."""
    strips = -(-w // STRIP)
    total = -(-c // CHANNELS_A_BLOCK) * b * strips * h
    out = []
    for blk in range(grid):
        lo, hi = total * blk // grid, total * (blk + 1) // grid
        runs = []
        while lo < hi:
            item, i0 = divmod(lo, h)
            i1 = min(h, i0 + hi - lo)
            rest, strip = divmod(item, strips)
            group, image = divmod(rest, b)
            runs.append((group, image, strip, i0, i1))
            lo += i1 - i0
        out.append(runs)
    return out


def group_blocks(b, h, w, c, grid, group):
    """(first, last) block whose rows meet channel group ``group``: the
    blocks whose partial sums the group's dw / db add, in order."""
    per_group = b * -(-w // STRIP) * h
    total = -(-c // CHANNELS_A_BLOCK) * per_group
    first, last = group * per_group, (group + 1) * per_group - 1
    return ((first + 1) * grid - 1) // total, ((last + 1) * grid - 1) // total


_MAP_DTYPES = (torch.bfloat16, torch.float32)


def _lib_fwd():
    """``depthwise_conv2d_fwd``: x; the taps and their (di, dj, c) strides
    and fp32 flag; the bias, its stride and fp32 flag; out; B, H, W, C, k,
    fp32 maps; the stream."""
    fn = _build.load("depthwise_conv2d").depthwise_conv2d_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _LL, _LL, _LL, _I, _P, _LL, _I, _P] + [_I] * 6 + [_P]
        fn.restype = _I
    return fn


def _lib_bwd():
    """``depthwise_conv2d_bwd``: x, g; the taps as for the forward; dx, dw,
    db; the partial rows and their count; the tickets; B, H, W, C, k, fp32
    maps; the stream."""
    fn = _build.load("depthwise_conv2d").depthwise_conv2d_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _LL, _LL, _LL, _I, _P, _P, _P, _P, _LL, _P] + [_I] * 6 + [_P]
        fn.restype = _I
    return fn


def _lib_attrs():
    fn = _build.load("depthwise_conv2d").depthwise_conv2d_attrs
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _P]
        fn.restype = _I
    return fn


def kernel_resources(dtype, backward=False):
    """Registers and spilled bytes a thread, shared bytes a block, resident
    blocks an SM, threads a block and output columns a strip of the forward
    (or the backward) kernel for maps of dtype, on the current device."""
    out = (ctypes.c_int * 6)()
    _build.check(_lib_attrs()(int(dtype == torch.float32), int(backward), out),
                 "depthwise_conv2d attributes")
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm", "threads",
                     "strip_columns"), out))


@functools.lru_cache(maxsize=None)
def _resident(device_index, fp32):
    """The backward kernel's resident blocks on the card: its grid at most."""
    with torch.cuda.device(device_index):
        per_sm = kernel_resources(torch.float32 if fp32 else torch.bfloat16, True)["blocks_per_sm"]
    return torch.cuda.get_device_properties(device_index).multi_processor_count * per_sm


_MAP_DTYPES = (torch.bfloat16, torch.float32)


def _check(x, kernel, bias=None, what="depthwise_conv2d"):
    """Raise for what the kernels do not take (the bias: the forward's)."""
    c = x.shape[-1]
    if x.dtype not in _MAP_DTYPES:
        raise TypeError(f"{what} kernel takes bfloat16 or float32 maps, got {x.dtype}")
    if kernel.shape != (_KERNEL_SIZE, _KERNEL_SIZE, 1, c):
        raise ValueError(f"{what} kernel takes a ({_KERNEL_SIZE}, {_KERNEL_SIZE}, 1, {c}) "
                         f"kernel, got {tuple(kernel.shape)}")
    if kernel.dtype not in _MAP_DTYPES:
        raise TypeError(f"{what} kernel takes bfloat16 or float32 taps, got {kernel.dtype}")
    if bias is not None and (bias.shape != (c,) or bias.dtype not in _MAP_DTYPES):
        raise ValueError(f"{what} kernel takes a ({c},) bfloat16 or float32 bias, got "
                         f"{tuple(bias.shape)} {bias.dtype}")


def _taps(kernel):
    """The (7, 7, C) taps in place: pointer, (di, dj, c) strides, fp32 flag."""
    w = kernel[:, :, 0, :]
    return (w.data_ptr(), *w.stride(), int(w.dtype == torch.float32))


def _launch(x, kernel, bias):
    """One launch of the forward kernel (uncounted): same-padded depthwise
    of x."""
    b, h, w, c = x.shape
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib_fwd()(x.data_ptr(), *_taps(kernel), bias.data_ptr(), bias.stride(0),
                            int(bias.dtype == torch.float32), out.data_ptr(), b, h, w, c,
                            _KERNEL_SIZE, int(x.dtype == torch.float32),
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "depthwise_conv2d launch")
    return out


def _bwd_launch(x, kernel, g):
    """One launch of the backward kernel (uncounted): dx in x's dtype, dw
    (7, 7, 1, C) and db (C,) fp32."""
    b, h, w, c = x.shape
    x, g = x.contiguous(), g.contiguous()
    dx = torch.empty_like(x)
    if dx.numel() == 0:  # no pixel: the sums are 0
        return (dx, torch.zeros((_KERNEL_SIZE, _KERNEL_SIZE, 1, c), device=x.device),
                torch.zeros((c,), device=x.device))
    dw = torch.empty((_KERNEL_SIZE * _KERNEL_SIZE, c), dtype=torch.float32, device=x.device)
    db = torch.empty((c,), dtype=torch.float32, device=x.device)
    groups = -(-c // CHANNELS_A_BLOCK)
    rows = _resident(x.device.index, x.dtype == torch.float32) + groups
    part = torch.empty((rows, PARTS, CHANNELS_A_BLOCK), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib_bwd()(x.data_ptr(), g.data_ptr(), *_taps(kernel), dx.data_ptr(),
                            dw.data_ptr(), db.data_ptr(), part.data_ptr(), rows,
                            _build.tickets(x.device, groups).data_ptr(), b, h, w, c,
                            _KERNEL_SIZE, int(x.dtype == torch.float32),
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "depthwise_conv2d backward launch")
    return dx, dw.reshape(_KERNEL_SIZE, _KERNEL_SIZE, 1, c), db


def depthwise_conv2d_bwd(x, kernel, g):
    """Gradients of depthwise_conv2d from its input x, taps and output
    gradient g: (dx in x.dtype, dw, db fp32). On CUDA (x and g both bf16
    or both fp32) one launch of the backward kernel writes all three,
    counted in ``depthwise_conv2d_bwd.launches``; CPU tensors take the
    plain version."""
    if not x.is_cuda:
        return depthwise_conv2d_bwd_plain(x, kernel, g)
    _check(g, kernel, what="depthwise_conv2d backward")
    _check(x, kernel, what="depthwise_conv2d backward")
    if g.dtype != x.dtype:
        raise TypeError(f"depthwise_conv2d backward kernel takes g in x's dtype ({x.dtype}), "
                        f"got {g.dtype}")
    if g.shape != x.shape:
        raise ValueError(f"depthwise_conv2d backward: g {tuple(g.shape)} for x {tuple(x.shape)}")
    out = _bwd_launch(x, kernel, g)
    depthwise_conv2d_bwd.launches += 1
    return out


depthwise_conv2d_bwd.launches = 0


class _DepthwiseConv2dFn(torch.autograd.Function):
    """depthwise_conv2d under autograd on CUDA: the forward kernel, and the
    backward kernel (the JAX custom VJP ``_dw_fwd`` / ``_dw_bwd``)."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        ctx.bias_dtype = bias.dtype
        return _forward(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        dx, dw, db = depthwise_conv2d_bwd(x, kernel, g)
        return dx, dw.to(kernel.dtype), db.to(ctx.bias_dtype)


def _forward(x, kernel, bias):
    out = _launch(x, kernel, bias)
    depthwise_conv2d.launches += 1
    return out


def depthwise_conv2d(x, kernel, bias):
    """Same-padded depthwise conv. x (B, H, W, C); kernel (k, k, 1, C);
    bias (C,). Returns (B, H, W, C) in x.dtype."""
    if not x.is_cuda:
        return depthwise_conv2d_plain(x, kernel, bias)
    _check(x, kernel, bias)
    if _build.needs_grad(x, kernel, bias):
        return _DepthwiseConv2dFn.apply(x, kernel, bias)
    return _forward(x, kernel, bias)


depthwise_conv2d.launches = 0
