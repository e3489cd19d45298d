"""Same-padded depthwise 2D convolution over NHWC maps: a CUDA kernel for
the H100 and its plain PyTorch version, forward and backward.

Replaces the Pallas kernel ``efficientsam3_tpu/ops/pallas/depthwise.py``
(``_dw_call`` / ``_dw_kernel``) and its custom VJP (``_dw_bwd``): the 7x7
depthwise conv of the tracker memory encoder's ConvNeXt fuser
(``models/memory_encoder.CXBlock``), fp32 accumulation, bias, output in the
input dtype. The kernel is CUDA C++ in ``csrc/depthwise_conv2d.cu`` (see
its note for what bounds it), built by ``ops/_build.py`` on first use.

The backward follows ``_dw_bwd``: dx is the same kernel run over the output
gradient with the taps flipped on both spatial axes and a zero bias (a
same-padded correlation's adjoint), cast to x's dtype; dw and db, jnp
reductions outside any Pallas kernel in JAX, are fp32 sums by a second
kernel of the same source (``depthwise_conv2d_wgrad``: per-tile partial
sums from one read of x and g, finished by one sum), cast to the taps' and
the bias's dtypes. Their plain version is the JAX reductions' arithmetic.

The kernel takes any channel count and any map size. The JAX package's
dispatch rule ``use_pallas_depthwise`` (channels a multiple of 128, maps
within the VMEM budget) only existed for the TPU's lanes and fast memory;
here every CXBlock depthwise on a CUDA tensor goes to the kernel. CPU
tensors take the plain version (differentiated by autograd); a CUDA tensor
the kernel does not take (maps other than bf16 or fp32, a kernel size other
than 7; in the backward an output gradient of another dtype than x) raises.
Both dtypes run the kernel (fp32 arithmetic either way; the fp32
instantiation stages fp32 tiles of 16 channels). When autograd
records the call on CUDA it runs as ``_DepthwiseConv2dFn``.
``depthwise_conv2d.launches`` counts the forward's launches,
``depthwise_conv2d_bwd.launches`` the backward's calls (each launches the
dx and the weight-gradient kernel once).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from efficientsam3_tpu_torch.ops import _build

_KERNEL_SIZE = 7
_I, _P = ctypes.c_int, ctypes.c_void_p


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


_MAP_DTYPES = (torch.bfloat16, torch.float32)


def _lib(name="depthwise_conv2d_fwd"):
    fn = getattr(_build.load("depthwise_conv2d"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        fn.restype = _I
    return fn


def _check(x, kernel, bias, what="depthwise_conv2d"):
    c = x.shape[-1]
    if x.dtype not in _MAP_DTYPES:
        raise TypeError(f"{what} kernel takes bfloat16 or float32 maps, got {x.dtype}")
    if kernel.shape != (_KERNEL_SIZE, _KERNEL_SIZE, 1, c) or bias.shape != (c,):
        raise ValueError(f"{what} kernel takes a ({_KERNEL_SIZE}, {_KERNEL_SIZE}, 1, "
                         f"{c}) kernel and ({c},) bias, got {tuple(kernel.shape)} and "
                         f"{tuple(bias.shape)}")


def _launch(x, kernel, bias):
    """One launch of the kernel (uncounted): same-padded depthwise of x."""
    b, h, w, c = x.shape
    x = x.contiguous()
    wk = kernel[:, :, 0, :].float().contiguous()
    bs = bias.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib()(x.data_ptr(), wk.data_ptr(), bs.data_ptr(), out.data_ptr(),
                        b, h, w, c, _KERNEL_SIZE, int(x.dtype == torch.float32),
                        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "depthwise_conv2d launch")
    return out


def _wgrad(x, g):
    """dw (7, 7, 1, C) and db (C,) fp32 by the weight-gradient kernel: one
    launch writes per-tile partial sums, one sum finishes them."""
    b, h, w, c = x.shape
    x, g = x.contiguous(), g.contiguous()
    blocks = b * -(-h // 8) * -(-w // 16)  # the kernel's 8 x 16 output tiles
    dwp = torch.empty((blocks, _KERNEL_SIZE * _KERNEL_SIZE, c), dtype=torch.float32,
                      device=x.device)
    dbp = torch.empty((blocks, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib("depthwise_conv2d_wgrad")(
            x.data_ptr(), g.data_ptr(), dwp.data_ptr(), dbp.data_ptr(), b, h, w, c,
            _KERNEL_SIZE, int(x.dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "depthwise_conv2d_wgrad launch")
    return dwp.sum(0).reshape(_KERNEL_SIZE, _KERNEL_SIZE, 1, c), dbp.sum(0)


def depthwise_conv2d_bwd(x, kernel, g):
    """Gradients of depthwise_conv2d from its input x, taps and output
    gradient g: (dx in x.dtype, dw, db fp32). On CUDA (x and g both bf16
    or both fp32) one call launches the kernel over g with the flipped taps for dx and the
    weight-gradient kernel for dw / db, counted once in
    ``depthwise_conv2d_bwd.launches``; CPU tensors take the plain version."""
    if not x.is_cuda:
        return depthwise_conv2d_bwd_plain(x, kernel, g)
    zero = torch.zeros(kernel.shape[-1], dtype=torch.float32, device=x.device)
    _check(g, kernel, zero, "depthwise_conv2d backward")
    _check(x, kernel, zero, "depthwise_conv2d backward")
    if g.dtype != x.dtype:
        raise TypeError(f"depthwise_conv2d backward kernel takes g in x's dtype ({x.dtype}), "
                        f"got {g.dtype}")
    if g.shape != x.shape:
        raise ValueError(f"depthwise_conv2d backward: g {tuple(g.shape)} for x {tuple(x.shape)}")
    dx = _launch(g, kernel.flip(0, 1), zero)
    dw, db = _wgrad(x, g)
    depthwise_conv2d_bwd.launches += 1
    return dx, dw, db


depthwise_conv2d_bwd.launches = 0


class _DepthwiseConv2dFn(torch.autograd.Function):
    """depthwise_conv2d under autograd on CUDA: the forward kernel, and a
    backward of the kernel over the flipped taps plus the weight-gradient
    kernel (the JAX custom VJP ``_dw_fwd`` / ``_dw_bwd``)."""

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
